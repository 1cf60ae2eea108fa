// BLS12-381 full-scheme CPU oracle.
//
// Native ground truth for hbbft_tpu_torch/crypto/{bls12_381,tc}.py and the device
// kernels in ops/{fp381,gcurve}.py — the role the `threshold_crypto` crate
// plays for the reference (SURVEY §2.2 row 2).  Same algorithms as the host
// Python (affine Miller loop, cube-of-ate final exponentiation, w-basis
// Fp12, try-and-increment hashing), so parity tests can compare exact
// bytes, not just accept/reject outcomes.  Constants come from
// bls381_constants.h, generated from the Python derivation at build time.
//
// Field arithmetic: 64-bit-limb Montgomery (CIOS) via unsigned __int128.
// Exposed through a C ABI on the host serialization formats (G1 = 97
// bytes, G2 = 193, scalars = 32 big-endian) and loaded with ctypes.

#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "bls381_constants.h"

extern "C" void hbbft_sha3_256(const uint8_t* data, int64_t len,
                               uint8_t* out32);

#if defined(__x86_64__) && defined(__ADX__) && defined(__BMI2__)
// ADX/BMI2 dual-carry-chain Montgomery mul (bls381_mont.S) — ~4× the
// __int128 C fallback below, which stays as its differential-test oracle.
// The guard ties dispatch to the BUILD host's features; the library is
// always built on the machine that runs it (first-use make in oracle.py).
#define HBBFT_MONT_ASM 1
extern "C" void hbbft_mont_mul_384(uint64_t* out, const uint64_t* a,
                                   const uint64_t* b, const uint64_t* p,
                                   uint64_t n0);
#endif

namespace bls {

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// generic N-limb Montgomery modular arithmetic
// ---------------------------------------------------------------------------

template <int N>
struct Mod {
  u64 p[N];
  u64 n0;      // -p^{-1} mod 2^64
  u64 r2[N];   // 2^{128N} mod p
  u64 one[N];  // 2^{64N} mod p  (Montgomery form of 1)

  static int cmp(const u64* a, const u64* b) {
    for (int i = N - 1; i >= 0; --i) {
      if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
  }

  static bool is_zero(const u64* a) {
    for (int i = 0; i < N; ++i)
      if (a[i]) return false;
    return true;
  }

  // out = a + b, returns carry
  static u64 raw_add(const u64* a, const u64* b, u64* out) {
    u128 c = 0;
    for (int i = 0; i < N; ++i) {
      c += (u128)a[i] + b[i];
      out[i] = (u64)c;
      c >>= 64;
    }
    return (u64)c;
  }

  // out = a - b, returns borrow
  static u64 raw_sub(const u64* a, const u64* b, u64* out) {
    u128 br = 0;
    for (int i = 0; i < N; ++i) {
      u128 d = (u128)a[i] - b[i] - br;
      out[i] = (u64)d;
      br = (d >> 64) & 1;
    }
    return (u64)br;
  }

  void init(const u64* prime) {
    memcpy(p, prime, sizeof(p));
    // n0 via Newton on 64 bits
    u64 x = 1;
    for (int i = 0; i < 6; ++i) x *= 2 - p[0] * x;
    n0 = (u64)(0 - x);
    // one = 2^{64N} mod p by repeated doubling of 1
    u64 t[N] = {1};
    for (int i = 0; i < 64 * N; ++i) dbl_mod(t);
    memcpy(one, t, sizeof(one));
    // r2 = 2^{128N} mod p: keep doubling
    for (int i = 0; i < 64 * N; ++i) dbl_mod(t);
    memcpy(r2, t, sizeof(r2));
  }

  void dbl_mod(u64* a) const {
    u64 t[N];
    u64 carry = raw_add(a, a, t);
    if (carry || cmp(t, p) >= 0) raw_sub(t, p, t);
    memcpy(a, t, sizeof(u64) * N);
  }

  void add(const u64* a, const u64* b, u64* out) const {
    u64 t[N];
    u64 carry = raw_add(a, b, t);
    if (carry || cmp(t, p) >= 0) raw_sub(t, p, t);
    memcpy(out, t, sizeof(t));
  }

  void sub(const u64* a, const u64* b, u64* out) const {
    u64 t[N];
    if (raw_sub(a, b, t)) raw_add(t, p, t);
    memcpy(out, t, sizeof(t));
  }

  void neg(const u64* a, u64* out) const {
    if (is_zero(a)) {
      memset(out, 0, sizeof(u64) * N);
      return;
    }
    u64 t[N];
    raw_sub(p, a, t);
    memcpy(out, t, sizeof(t));
  }

  // CIOS Montgomery multiplication
  void mul(const u64* a, const u64* b, u64* out) const {
#ifdef HBBFT_MONT_ASM
    if constexpr (N == 6) {
      hbbft_mont_mul_384(out, a, b, p, n0);
      return;
    }
#endif
    u64 t[N + 2];
    memset(t, 0, sizeof(t));
    for (int i = 0; i < N; ++i) {
      u128 c = 0;
      for (int j = 0; j < N; ++j) {
        c += (u128)t[j] + (u128)a[i] * b[j];
        t[j] = (u64)c;
        c >>= 64;
      }
      c += t[N];
      t[N] = (u64)c;
      t[N + 1] = (u64)(c >> 64);
      u64 m = t[0] * n0;
      c = (u128)t[0] + (u128)m * p[0];
      c >>= 64;
      for (int j = 1; j < N; ++j) {
        c += (u128)t[j] + (u128)m * p[j];
        t[j - 1] = (u64)c;
        c >>= 64;
      }
      c += t[N];
      t[N - 1] = (u64)c;
      t[N] = t[N + 1] + (u64)(c >> 64);
    }
    if (t[N] || cmp(t, p) >= 0) raw_sub(t, p, t);
    memcpy(out, t, sizeof(u64) * N);
  }

  void sqr(const u64* a, u64* out) const { mul(a, a, out); }

  void from_raw(const u64* raw, u64* out) const { mul(raw, r2, out); }

  void to_raw(const u64* m, u64* out) const {
    u64 u[N] = {1};
    mul(m, u, out);
  }

  // out = base^e (e raw little-endian, nlimbs), Montgomery in/out
  void pow(const u64* base, const u64* e, int nlimbs, u64* out) const {
    u64 acc[N];
    memcpy(acc, one, sizeof(acc));
    int bits = nlimbs * 64;
    for (int i = bits - 1; i >= 0; --i) {
      sqr(acc, acc);
      if ((e[i / 64] >> (i % 64)) & 1) mul(acc, base, acc);
    }
    memcpy(out, acc, sizeof(acc));
  }

  void inv(const u64* a, u64* out) const {
    // p - 2 exponent supplied by caller wrappers; generic: compute here
    u64 e[N];
    u64 two[N] = {2};
    raw_sub(p, two, e);
    pow(a, e, N, out);
  }
};

static Mod<6> FP;
static Mod<4> FR;
static bool g_init = false;

struct Fp2 {
  u64 a[6];
  u64 b[6];
};

static Fp2 FP2_ZERO_, FP2_ONE_;
static Fp2 GAMMA_M[6];
static Fp2 B2_M;       // 4(u+1) in Montgomery
static u64 B1_M[6];    // 4
static u64 HALF_M[6];  // 1/2
static Fp2 PSI_CX_M, PSI_CY_M;  // ψ endomorphism constants (Montgomery)
static u64 GLV_BETA_M[6];       // G1 endomorphism β (Montgomery)

static void init_all() {
  if (g_init) return;
  FP.init(BLS_P);
  FR.init(BLS_R);
  memset(&FP2_ZERO_, 0, sizeof(FP2_ZERO_));
  memset(&FP2_ONE_, 0, sizeof(FP2_ONE_));
  memcpy(FP2_ONE_.a, FP.one, sizeof(FP.one));
  for (int i = 0; i < 6; ++i) {
    FP.from_raw(BLS_GAMMA[i][0], GAMMA_M[i].a);
    FP.from_raw(BLS_GAMMA[i][1], GAMMA_M[i].b);
  }
  u64 four[6] = {4};
  FP.from_raw(four, B1_M);
  memcpy(B2_M.a, B1_M, sizeof(B1_M));
  memcpy(B2_M.b, B1_M, sizeof(B1_M));
  FP.from_raw(BLS_HALF, HALF_M);
  FP.from_raw(BLS_PSI_CX[0], PSI_CX_M.a);
  FP.from_raw(BLS_PSI_CX[1], PSI_CX_M.b);
  FP.from_raw(BLS_PSI_CY[0], PSI_CY_M.a);
  FP.from_raw(BLS_PSI_CY[1], PSI_CY_M.b);
  FP.from_raw(BLS_GLV_BETA, GLV_BETA_M);
  g_init = true;
}

// ---------------------------------------------------------------------------
// Fp2 (mirrors host: Karatsuba, ξ = 1 + u)
// ---------------------------------------------------------------------------

static void f2_add(const Fp2& x, const Fp2& y, Fp2& o) {
  FP.add(x.a, y.a, o.a);
  FP.add(x.b, y.b, o.b);
}
static void f2_sub(const Fp2& x, const Fp2& y, Fp2& o) {
  FP.sub(x.a, y.a, o.a);
  FP.sub(x.b, y.b, o.b);
}
static void f2_neg(const Fp2& x, Fp2& o) {
  FP.neg(x.a, o.a);
  FP.neg(x.b, o.b);
}
static void f2_mul(const Fp2& x, const Fp2& y, Fp2& o) {
  u64 t0[6], t1[6], sa[6], sb[6], t2[6];
  FP.mul(x.a, y.a, t0);
  FP.mul(x.b, y.b, t1);
  FP.add(x.a, x.b, sa);
  FP.add(y.a, y.b, sb);
  FP.mul(sa, sb, t2);
  FP.sub(t0, t1, o.a);
  u64 s[6];
  FP.add(t0, t1, s);
  FP.sub(t2, s, o.b);
}
static void f2_sqr(const Fp2& x, Fp2& o) {
  u64 s[6], d[6], t[6];
  FP.add(x.a, x.b, s);
  FP.sub(x.a, x.b, d);
  FP.mul(x.a, x.b, t);
  FP.mul(s, d, o.a);
  FP.add(t, t, o.b);
}
static void f2_mul_xi(const Fp2& x, Fp2& o) {  // (a+bu)(1+u) = (a−b) + (a+b)u
  u64 na[6], nb[6];
  FP.sub(x.a, x.b, na);
  FP.add(x.a, x.b, nb);
  memcpy(o.a, na, sizeof(na));
  memcpy(o.b, nb, sizeof(nb));
}
static void f2_conj(const Fp2& x, Fp2& o) {
  memcpy(o.a, x.a, sizeof(x.a));
  FP.neg(x.b, o.b);
}
static bool f2_is_zero(const Fp2& x) {
  return Mod<6>::is_zero(x.a) && Mod<6>::is_zero(x.b);
}
static void f2_inv(const Fp2& x, Fp2& o) {
  u64 n[6], t[6], ninv[6];
  FP.sqr(x.a, n);
  FP.sqr(x.b, t);
  FP.add(n, t, n);  // norm = a² + b²
  FP.pow(n, BLS_P_M2, 6, ninv);
  FP.mul(x.a, ninv, o.a);
  u64 nb[6];
  FP.neg(x.b, nb);
  FP.mul(nb, ninv, o.b);
}
static void f2_scal_small(const Fp2& x, int k, Fp2& o) {
  Fp2 acc = FP2_ZERO_;
  for (int i = 0; i < k; ++i) f2_add(acc, x, acc);
  o = acc;
}

// Jacobi symbol of a (Montgomery in) over p — binary algorithm on raw
// limbs, ~1000× cheaper than the Euler-criterion pow.  Used as the QR
// pre-test in hash-to-curve: χ_Fp2(g) = jacobi(norm(g), p), so losing
// try-and-increment candidates cost no field exponentiations.
static int jacobi_m(const u64* a_m) {
  u64 a[6], n[6];
  FP.to_raw(a_m, a);      // a < p already
  memcpy(n, FP.p, sizeof(n));
  int t = 1;
  auto is_one = [](const u64* x) {
    if (x[0] != 1) return false;
    for (int i = 1; i < 6; ++i)
      if (x[i]) return false;
    return true;
  };
  auto shr1 = [](u64* x) {
    for (int i = 0; i < 5; ++i) x[i] = (x[i] >> 1) | (x[i + 1] << 63);
    x[5] >>= 1;
  };
  while (!Mod<6>::is_zero(a)) {
    while (!(a[0] & 1)) {
      shr1(a);
      u64 r8 = n[0] & 7;
      if (r8 == 3 || r8 == 5) t = -t;
    }
    if ((a[0] & 3) == 3 && (n[0] & 3) == 3) t = -t;
    u64 tmp[6];
    memcpy(tmp, a, sizeof(tmp));
    memcpy(a, n, sizeof(a));
    memcpy(n, tmp, sizeof(n));  // swap; now reduce a mod n (n odd, a < 2^384)
    while (Mod<6>::cmp(a, n) >= 0) {
      // subtract the largest n·2^s ≤ a (binary reduction, O(384) total)
      u64 t2[6];
      memcpy(t2, n, sizeof(t2));
      while (true) {
        u64 t3[6];
        bool of = t2[5] >> 63;
        for (int i = 5; i > 0; --i) t3[i] = (t2[i] << 1) | (t2[i - 1] >> 63);
        t3[0] = t2[0] << 1;
        if (of || Mod<6>::cmp(t3, a) > 0) break;
        memcpy(t2, t3, sizeof(t2));
      }
      Mod<6>::raw_sub(a, t2, a);
    }
  }
  return is_one(n) ? t : 0;
}

static bool fp_sqrt(const u64* a, u64* out) {  // Montgomery in/out
  u64 r[6], chk[6];
  FP.pow(a, BLS_SQRT_EXP, 6, r);
  FP.sqr(r, chk);
  if (Mod<6>::cmp(chk, a) != 0) return false;
  memcpy(out, r, sizeof(r));
  return true;
}

static bool f2_sqrt(const Fp2& x, Fp2& o) {  // mirrors host fp2_sqrt
  if (f2_is_zero(x)) {
    o = FP2_ZERO_;
    return true;
  }
  if (Mod<6>::is_zero(x.b)) {
    u64 s[6];
    if (fp_sqrt(x.a, s)) {
      memcpy(o.a, s, sizeof(s));
      memset(o.b, 0, sizeof(o.b));
      return true;
    }
    u64 na[6];
    FP.neg(x.a, na);
    if (!fp_sqrt(na, s)) return false;
    memset(o.a, 0, sizeof(o.a));
    memcpy(o.b, s, sizeof(s));
    return true;
  }
  u64 n[6], t[6], s[6];
  FP.sqr(x.a, n);
  FP.sqr(x.b, t);
  FP.add(n, t, n);
  if (!fp_sqrt(n, s)) return false;
  for (int sign = 0; sign < 2; ++sign) {
    u64 sg[6], half[6], alpha[6];
    if (sign == 0)
      memcpy(sg, s, sizeof(sg));
    else
      FP.neg(s, sg);
    FP.add(x.a, sg, half);
    FP.mul(half, HALF_M, half);
    // Jacobi pre-test picks the working sign branch without paying a
    // full exponentiation on the losing one (χ((a±s)/2) decides)
    if (jacobi_m(half) != 1) continue;
    if (!fp_sqrt(half, alpha) || Mod<6>::is_zero(alpha)) continue;
    u64 denom[6], dinv[6], beta[6];
    FP.add(alpha, alpha, denom);
    FP.pow(denom, BLS_P_M2, 6, dinv);
    FP.mul(x.b, dinv, beta);
    Fp2 cand, chk;
    memcpy(cand.a, alpha, sizeof(alpha));
    memcpy(cand.b, beta, sizeof(beta));
    f2_sqr(cand, chk);
    if (Mod<6>::cmp(chk.a, x.a) == 0 && Mod<6>::cmp(chk.b, x.b) == 0) {
      o = cand;
      return true;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// Fp12 in the w-basis (mirrors host)
// ---------------------------------------------------------------------------

struct Fp12 {
  Fp2 c[6];
};

static Fp12 f12_one() {
  Fp12 o;
  for (int i = 0; i < 6; ++i) o.c[i] = FP2_ZERO_;
  o.c[0] = FP2_ONE_;
  return o;
}

static void f12_mul(const Fp12& x, const Fp12& y, Fp12& o) {
  Fp2 acc[11];
  for (int i = 0; i < 11; ++i) acc[i] = FP2_ZERO_;
  Fp2 t;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      f2_mul(x.c[i], y.c[j], t);
      f2_add(acc[i + j], t, acc[i + j]);
    }
  Fp12 r;
  for (int k = 0; k < 6; ++k) r.c[k] = acc[k];
  for (int k = 6; k < 11; ++k) {
    f2_mul_xi(acc[k], t);
    f2_add(r.c[k - 6], t, r.c[k - 6]);
  }
  o = r;
}

static void f12_sqr(const Fp12& x, Fp12& o) { f12_mul(x, x, o); }

static void f12_conj(const Fp12& x, Fp12& o) {
  Fp12 r = x;
  f2_neg(x.c[1], r.c[1]);
  f2_neg(x.c[3], r.c[3]);
  f2_neg(x.c[5], r.c[5]);
  o = r;
}

// Fp6 helpers over v = w² (for inversion), mirroring the host
typedef Fp2 Fp6[3];
static void f6_mul(const Fp6& a, const Fp6& b, Fp6& o) {
  Fp2 t[5], tmp;
  for (int i = 0; i < 5; ++i) t[i] = FP2_ZERO_;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      f2_mul(a[i], b[j], tmp);
      f2_add(t[i + j], tmp, t[i + j]);
    }
  Fp2 r0, r1;
  f2_mul_xi(t[3], r0);
  f2_add(t[0], r0, o[0]);
  f2_mul_xi(t[4], r1);
  f2_add(t[1], r1, o[1]);
  o[2] = t[2];
}
static void f6_sub(const Fp6& a, const Fp6& b, Fp6& o) {
  for (int i = 0; i < 3; ++i) f2_sub(a[i], b[i], o[i]);
}
static void f6_neg(const Fp6& a, Fp6& o) {
  for (int i = 0; i < 3; ++i) f2_neg(a[i], o[i]);
}
static void f6_inv(const Fp6& x, Fp6& o) {
  Fp2 c0, c1, c2, t, t2, norm, ninv;
  f2_sqr(x[0], c0);
  f2_mul(x[1], x[2], t);
  f2_mul_xi(t, t);
  f2_sub(c0, t, c0);
  f2_sqr(x[2], t);
  f2_mul_xi(t, t);
  f2_mul(x[0], x[1], t2);
  f2_sub(t, t2, c1);
  f2_sqr(x[1], t);
  f2_mul(x[0], x[2], t2);
  f2_sub(t, t2, c2);
  // norm = x0·c0 + ξ(x2·c1 + x1·c2)
  f2_mul(x[2], c1, t);
  f2_mul(x[1], c2, t2);
  f2_add(t, t2, t);
  f2_mul_xi(t, t);
  f2_mul(x[0], c0, t2);
  f2_add(t2, t, norm);
  f2_inv(norm, ninv);
  f2_mul(c0, ninv, o[0]);
  f2_mul(c1, ninv, o[1]);
  f2_mul(c2, ninv, o[2]);
}

static void f12_inv(const Fp12& x, Fp12& o) {
  Fp6 A = {x.c[0], x.c[2], x.c[4]};
  Fp6 B = {x.c[1], x.c[3], x.c[5]};
  Fp6 A2, B2, vB2, denom, dinv, ne, no_;
  f6_mul(A, A, A2);
  f6_mul(B, B, B2);
  f2_mul_xi(B2[2], vB2[0]);
  vB2[1] = B2[0];
  vB2[2] = B2[1];
  f6_sub(A2, vB2, denom);
  f6_inv(denom, dinv);
  f6_mul(A, dinv, ne);
  f6_mul(B, dinv, no_);
  f6_neg(no_, no_);
  o.c[0] = ne[0];
  o.c[1] = no_[0];
  o.c[2] = ne[1];
  o.c[3] = no_[1];
  o.c[4] = ne[2];
  o.c[5] = no_[2];
}

static void f12_frob(const Fp12& x, int power, Fp12& o) {
  Fp12 r = x;
  for (int t = 0; t < power; ++t) {
    Fp12 nx;
    for (int i = 0; i < 6; ++i) {
      Fp2 cj;
      f2_conj(r.c[i], cj);
      f2_mul(cj, GAMMA_M[i], nx.c[i]);
    }
    r = nx;
  }
  o = r;
}

static void f12_pow_u(const Fp12& base, const u64* e, int nlimbs, Fp12& o) {
  Fp12 acc = f12_one();
  for (int i = nlimbs * 64 - 1; i >= 0; --i) {
    f12_sqr(acc, acc);
    if ((e[i / 64] >> (i % 64)) & 1) f12_mul(acc, base, acc);
  }
  o = acc;
}

static bool f12_is_one(const Fp12& x) {
  if (Mod<6>::cmp(x.c[0].a, FP.one) != 0) return false;
  if (!Mod<6>::is_zero(x.c[0].b)) return false;
  for (int i = 1; i < 6; ++i)
    if (!f2_is_zero(x.c[i])) return false;
  return true;
}

// ---------------------------------------------------------------------------
// curves: Jacobian points; inf flag explicit
// ---------------------------------------------------------------------------

struct G1 {
  u64 x[6], y[6], z[6];
  bool inf;
};
struct G2 {
  Fp2 x, y, z;
  bool inf;
};

static void g1_double(const G1& pt, G1& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  u64 a[6], b[6], c[6], d[6], e[6], f[6], t[6], t2[6];
  FP.sqr(pt.x, a);
  FP.sqr(pt.y, b);
  FP.sqr(b, c);
  FP.add(pt.x, b, t);
  FP.sqr(t, t);
  FP.add(a, c, t2);
  FP.sub(t, t2, d);
  FP.add(d, d, d);
  FP.add(a, a, e);
  FP.add(e, a, e);
  FP.sqr(e, f);
  G1 r;
  r.inf = false;
  FP.add(d, d, t);
  FP.sub(f, t, r.x);
  FP.sub(d, r.x, t);
  FP.mul(e, t, t);
  u64 c8[6];
  FP.add(c, c, c8);
  FP.add(c8, c8, c8);
  FP.add(c8, c8, c8);
  FP.sub(t, c8, r.y);
  FP.add(pt.y, pt.y, t);
  FP.mul(t, pt.z, r.z);
  o = r;
}

static void g1_add(const G1& p1, const G1& p2, G1& o) {
  if (p1.inf) {
    o = p2;
    return;
  }
  if (p2.inf) {
    o = p1;
    return;
  }
  u64 z1z1[6], z2z2[6], u1[6], u2[6], s1[6], s2[6], t[6];
  FP.sqr(p1.z, z1z1);
  FP.sqr(p2.z, z2z2);
  FP.mul(p1.x, z2z2, u1);
  FP.mul(p2.x, z1z1, u2);
  FP.mul(p1.y, p2.z, t);
  FP.mul(t, z2z2, s1);
  FP.mul(p2.y, p1.z, t);
  FP.mul(t, z1z1, s2);
  u64 h[6], r2[6];
  FP.sub(u2, u1, h);
  FP.sub(s2, s1, r2);
  if (Mod<6>::is_zero(h)) {
    if (Mod<6>::is_zero(r2)) {
      g1_double(p1, o);
      return;
    }
    o.inf = true;
    return;
  }
  u64 i[6], j[6], v[6];
  FP.add(h, h, t);
  FP.sqr(t, i);
  FP.mul(h, i, j);
  FP.add(r2, r2, r2);
  FP.mul(u1, i, v);
  G1 r;
  r.inf = false;
  FP.sqr(r2, t);
  FP.sub(t, j, t);
  u64 v2[6];
  FP.add(v, v, v2);
  FP.sub(t, v2, r.x);
  FP.sub(v, r.x, t);
  FP.mul(r2, t, t);
  u64 sj[6];
  FP.mul(s1, j, sj);
  FP.add(sj, sj, sj);
  FP.sub(t, sj, r.y);
  FP.mul(p1.z, p2.z, t);
  FP.add(t, t, t);
  FP.mul(t, h, r.z);
  o = r;
}

static void g1_mul_limbs(const G1& pt, const u64* k, int nlimbs, G1& o) {
  G1 acc;
  acc.inf = true;
  G1 add = pt;
  for (int i = 0; i < nlimbs * 64; ++i) {
    if ((k[i / 64] >> (i % 64)) & 1) g1_add(acc, add, acc);
    g1_double(add, add);
  }
  o = acc;
}

static void g2_double(const G2& pt, G2& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  Fp2 a, b, c, d, e, f, t, t2;
  f2_sqr(pt.x, a);
  f2_sqr(pt.y, b);
  f2_sqr(b, c);
  f2_add(pt.x, b, t);
  f2_sqr(t, t);
  f2_add(a, c, t2);
  f2_sub(t, t2, d);
  f2_add(d, d, d);
  f2_add(a, a, e);
  f2_add(e, a, e);
  f2_sqr(e, f);
  G2 r;
  r.inf = false;
  f2_add(d, d, t);
  f2_sub(f, t, r.x);
  f2_sub(d, r.x, t);
  f2_mul(e, t, t);
  Fp2 c8;
  f2_scal_small(c, 8, c8);
  f2_sub(t, c8, r.y);
  f2_add(pt.y, pt.y, t);
  f2_mul(t, pt.z, r.z);
  o = r;
}

static void g2_add(const G2& p1, const G2& p2, G2& o) {
  if (p1.inf) {
    o = p2;
    return;
  }
  if (p2.inf) {
    o = p1;
    return;
  }
  Fp2 z1z1, z2z2, u1, u2, s1, s2, t, h, r2;
  f2_sqr(p1.z, z1z1);
  f2_sqr(p2.z, z2z2);
  f2_mul(p1.x, z2z2, u1);
  f2_mul(p2.x, z1z1, u2);
  f2_mul(p1.y, p2.z, t);
  f2_mul(t, z2z2, s1);
  f2_mul(p2.y, p1.z, t);
  f2_mul(t, z1z1, s2);
  f2_sub(u2, u1, h);
  f2_sub(s2, s1, r2);
  if (f2_is_zero(h)) {
    if (f2_is_zero(r2)) {
      g2_double(p1, o);
      return;
    }
    o.inf = true;
    return;
  }
  Fp2 i, j, v;
  f2_add(h, h, t);
  f2_sqr(t, i);
  f2_mul(h, i, j);
  f2_add(r2, r2, r2);
  f2_mul(u1, i, v);
  G2 r;
  r.inf = false;
  f2_sqr(r2, t);
  f2_sub(t, j, t);
  Fp2 v2;
  f2_add(v, v, v2);
  f2_sub(t, v2, r.x);
  f2_sub(v, r.x, t);
  f2_mul(r2, t, t);
  Fp2 sj;
  f2_mul(s1, j, sj);
  f2_add(sj, sj, sj);
  f2_sub(t, sj, r.y);
  f2_mul(p1.z, p2.z, t);
  f2_add(t, t, t);
  f2_mul(t, h, r.z);
  o = r;
}

static void g2_mul_limbs(const G2& pt, const u64* k, int nlimbs, G2& o) {
  G2 acc;
  acc.inf = true;
  G2 add = pt;
  for (int i = 0; i < nlimbs * 64; ++i) {
    if ((k[i / 64] >> (i % 64)) & 1) g2_add(acc, add, acc);
    g2_double(add, add);
  }
  o = acc;
}

static void g1_affine(const G1& pt, G1& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  u64 zi[6], zi2[6];
  FP.pow(pt.z, BLS_P_M2, 6, zi);
  FP.sqr(zi, zi2);
  G1 r;
  r.inf = false;
  FP.mul(pt.x, zi2, r.x);
  FP.mul(pt.y, zi2, r.y);
  FP.mul(r.y, zi, r.y);
  memcpy(r.z, FP.one, sizeof(FP.one));
  o = r;
}

static void g2_affine(const G2& pt, G2& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  Fp2 zi, zi2;
  f2_inv(pt.z, zi);
  f2_sqr(zi, zi2);
  G2 r;
  r.inf = false;
  f2_mul(pt.x, zi2, r.x);
  f2_mul(pt.y, zi2, r.y);
  f2_mul(r.y, zi, r.y);
  r.z = FP2_ONE_;
  o = r;
}

// ---------------------------------------------------------------------------
// endomorphism fast paths (mirrors crypto/bls12_381.py: g2_psi,
// g2_clear_cofactor; crypto/batch.py: the GLV split).  ψ acts as [p] ≡ [X]
// (mod r) on G2 and φ as [λ] on G1, so full-range scalars split into 64/128-
// bit digit ladders.  PRECONDITION for the *_glv/*_gls muls: the input point
// lies in the r-order subgroup (guaranteed by the Python layer — wire
// deserialization subgroup-checks, and hash outputs are cofactor-cleared);
// the exported generic bls_g1_mul/bls_g2_mul stay plain ladders because the
// Python subgroup checks themselves route through them.
// ---------------------------------------------------------------------------

static void g2_psi(const G2& pt, G2& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  Fp2 xc, yc, zc;
  f2_conj(pt.x, xc);
  f2_conj(pt.y, yc);
  f2_conj(pt.z, zc);
  o.inf = false;
  f2_mul(PSI_CX_M, xc, o.x);
  f2_mul(PSI_CY_M, yc, o.y);
  o.z = zc;
}

static void g2_neg_pt(const G2& pt, G2& o) {
  o = pt;
  if (!pt.inf) f2_neg(pt.y, o.y);
}

static void g1_endo(const G1& pt, G1& o) {  // φ(X,Y,Z) = (β·X, Y, Z)
  o = pt;
  if (!pt.inf) FP.mul(GLV_BETA_M, pt.x, o.x);
}

// [|x|]P — 64-bit ladder (x = BLS parameter, negative; callers negate)
static void g2_mul_xabs(const G2& pt, G2& o) {
  u64 k = BLS_X_ABS;
  g2_mul_limbs(pt, &k, 1, o);
}

// Budroni–Pintore cofactor clearing: [x²−x−1]P + [x−1]ψ(P) + ψ²([2]P).
// Valid for ANY point of E'(Fp2); image lies in G2.  Two 64-bit ladders
// replace the naive 512-bit [h₂] multiplication (~8× fewer point ops).
static void g2_clear_cofactor(const G2& pt, G2& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  G2 a, b, t1, t2, t3, neg;
  g2_mul_xabs(pt, a);
  g2_neg_pt(a, a);  // [x]P
  g2_mul_xabs(a, b);
  g2_neg_pt(b, b);  // [x²]P
  g2_neg_pt(a, neg);
  g2_add(b, neg, t1);
  g2_neg_pt(pt, neg);
  g2_add(t1, neg, t1);  // [x²−x−1]P
  g2_add(a, neg, t2);
  g2_psi(t2, t2);  // [x−1]ψ(P)
  g2_double(pt, t3);
  g2_psi(t3, t3);
  g2_psi(t3, t3);  // ψ²([2]P)
  g2_add(t1, t2, o);
  g2_add(o, t3, o);
}

// -- small bignum helpers for the scalar decompositions ---------------------

// mag (4 limbs) divmod u64: returns remainder, quotient in-place
static u64 divmod_u64(u64* mag, u64 d) {
  u128 rem = 0;
  for (int i = 3; i >= 0; --i) {
    u128 cur = (rem << 64) | mag[i];
    mag[i] = (u64)(cur / d);
    rem = cur % d;
  }
  return (u64)rem;
}

static bool mag_is_zero(const u64* m) {
  return !(m[0] | m[1] | m[2] | m[3]);
}

// GLS digits: k (raw, < r) = d0 + x·(d1 + x·(d2 + x·(d3 + x·d4))), all
// d_i ∈ [0, |x|) (d4 ∈ {0, 1} in practice — |x|⁴ > r−... the alternating-
// sign division makes every digit non-negative; verified exhaustively in
// the Python design check).  Returns false only if k fails to terminate in
// 5 digits (never for k < r; defensive).
static bool gls_digits(const u64* kraw4, u64 d[5]) {
  u64 mag[4];
  memcpy(mag, kraw4, sizeof(mag));
  bool neg = false;
  for (int i = 0; i < 5; ++i) {
    u64 rem = divmod_u64(mag, BLS_X_ABS);
    if (!neg) {
      // v ≥ 0: d = rem; v' = −(v − d)/|x| (quotient already in mag)
      d[i] = rem;
      neg = !mag_is_zero(mag);
    } else {
      // v < 0 (mag holds |v|): d = (|x| − rem) mod |x|; v' = (|v| + d)/|x|
      if (rem == 0) {
        d[i] = 0;
      } else {
        d[i] = BLS_X_ABS - rem;
        // (|v| + d) = (quot·|x| + rem + |x| − rem) = (quot + 1)·|x|
        u64 carry = 1;
        for (int j = 0; j < 4 && carry; ++j) {
          mag[j] += carry;
          carry = (mag[j] == 0);
        }
      }
      neg = false;
    }
  }
  return mag_is_zero(mag);
}

// wNAF-3 recoding of a 64-bit value: signed digits in {0, ±1, ±3}, average
// nonzero density 1/4.  out must hold 66 entries; returns digit count.
static int wnaf3(u64 k, int8_t* out) {
  int n = 0;
  while (k) {
    if (k & 1) {
      int d = (int)(k & 7);
      if (d > 4) d -= 8;  // d ∈ {−3, −1, 1, 3}
      out[n++] = (int8_t)d;
      k -= (u64)((int64_t)d);
    } else {
      out[n++] = 0;
    }
    k >>= 1;
  }
  return n;
}

// [k]P for P ∈ G2, k raw 4-limb < r: ψ-Horner as one joint wNAF-3 ladder
// over Q_i = ψ^i(P) — ~64 doubles + ~80 signed adds vs the generic
// ladder's 512 doubles + ~256 adds (≈ 5× fewer point operations).
static void g2_mul_gls(const G2& pt, const u64* kraw4, G2& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  u64 d[5];
  if (!gls_digits(kraw4, d)) {  // defensive fallback; unreachable for k < r
    g2_mul_limbs(pt, kraw4, 4, o);
    return;
  }
  G2 q1[5], q3[5];  // ψ^i(P) and 3·ψ^i(P)
  q1[0] = pt;
  for (int i = 1; i < 5; ++i) g2_psi(q1[i - 1], q1[i]);
  for (int i = 0; i < 5; ++i) {
    G2 t2;
    g2_double(q1[i], t2);
    g2_add(t2, q1[i], q3[i]);
  }
  int8_t naf[5][66];
  int len = 0;
  for (int i = 0; i < 5; ++i) {
    int n = wnaf3(d[i], naf[i]);
    for (int j = n; j < 66; ++j) naf[i][j] = 0;
    if (n > len) len = n;
  }
  G2 acc;
  acc.inf = true;
  for (int b = len - 1; b >= 0; --b) {
    g2_double(acc, acc);
    for (int i = 0; i < 5; ++i) {
      int8_t dg = naf[i][b];
      if (!dg) continue;
      G2 t = (dg == 1 || dg == -1) ? q1[i] : q3[i];
      if (dg < 0) g2_neg_pt(t, t);
      g2_add(acc, t, acc);
    }
  }
  o = acc;
}

// [k]P for P ∈ G1, k raw 4-limb < r: GLV split k = a + b·λ (both < 2^128)
// as one joint 128-bit ladder over P, φ(P).
static void g1_mul_glv(const G1& pt, const u64* kraw4, G1& o) {
  if (pt.inf) {
    o = pt;
    return;
  }
  // divide k by λ (2-limb) via binary shift-subtract: ~130 cheap word ops
  u64 rem[4];
  memcpy(rem, kraw4, sizeof(rem));
  u64 a[2] = {0, 0}, bq[2] = {0, 0};
  int lam_bits = 127;
  while (!((BLS_GLV_LAMBDA[lam_bits / 64] >> (lam_bits % 64)) & 1)) --lam_bits;
  for (int sh = 255 - lam_bits; sh >= 0; --sh) {
    // t = λ << sh (5 limbs to be safe)
    u64 t[5] = {0};
    int w = sh / 64, s = sh % 64;
    for (int i = 0; i < 2; ++i) {
      t[i + w] |= s ? (BLS_GLV_LAMBDA[i] << s) : BLS_GLV_LAMBDA[i];
      if (s) t[i + w + 1] |= BLS_GLV_LAMBDA[i] >> (64 - s);
    }
    // rem >= t ?
    bool ge = true;
    if (t[4]) ge = false;
    if (ge) {
      for (int i = 3; i >= 0; --i) {
        if (rem[i] != t[i]) {
          ge = rem[i] > t[i];
          break;
        }
      }
    }
    if (ge) {
      u128 br = 0;
      for (int i = 0; i < 4; ++i) {
        u128 dd = (u128)rem[i] - t[i] - br;
        rem[i] = (u64)dd;
        br = (dd >> 64) & 1;
      }
      bq[sh / 64] |= 1ULL << (sh % 64);
    }
  }
  memcpy(a, rem, sizeof(a));  // a = k mod λ < 2^127, b = k / λ < 2^128

  // joint wNAF-3 ladder over P, φ(P) (and their 3-multiples): ~128 doubles
  // + ~64 signed adds vs the naive 256 doubles + ~128 adds
  G1 base[2], base3[2];
  base[0] = pt;
  g1_endo(pt, base[1]);
  for (int i = 0; i < 2; ++i) {
    G1 t2;
    g1_double(base[i], t2);
    g1_add(t2, base[i], base3[i]);
  }
  // 128-bit wNAF-3: recode (lo, hi) limb pairs
  auto wnaf128 = [](u64 lo, u64 hi, int8_t* out) {
    int n = 0;
    while (lo | hi) {
      if (lo & 1) {
        int d = (int)(lo & 7);
        if (d > 4) d -= 8;
        out[n++] = (int8_t)d;
        u64 old = lo;
        lo -= (u64)((int64_t)d);
        if ((int64_t)d < 0 && lo < old) ++hi;       // carry on += wrap
        if ((int64_t)d > 0 && lo > old) --hi;       // borrow on −= wrap
      } else {
        out[n++] = 0;
      }
      lo = (lo >> 1) | (hi << 63);
      hi >>= 1;
    }
    return n;
  };
  int8_t naf[2][131];
  int len = 0;
  u64 sc[2][2] = {{a[0], a[1]}, {bq[0], bq[1]}};
  for (int i = 0; i < 2; ++i) {
    int n = wnaf128(sc[i][0], sc[i][1], naf[i]);
    for (int j = n; j < 131; ++j) naf[i][j] = 0;
    if (n > len) len = n;
  }
  G1 acc;
  acc.inf = true;
  for (int b = len - 1; b >= 0; --b) {
    g1_double(acc, acc);
    for (int i = 0; i < 2; ++i) {
      int8_t dg = naf[i][b];
      if (!dg) continue;
      G1 t = (dg == 1 || dg == -1) ? base[i] : base3[i];
      if (dg < 0) FP.neg(t.y, t.y);
      g1_add(acc, t, acc);
    }
  }
  o = acc;
}

// -- fixed-base tables -------------------------------------------------------

static void load_gen(G1& gen) {
  gen.inf = false;
  FP.from_raw(BLS_G1_X, gen.x);
  FP.from_raw(BLS_G1_Y, gen.y);
  memcpy(gen.z, FP.one, sizeof(FP.one));
}

// generator table: T[w·255 + d−1] = [d·2^{8w}]·G, w ∈ 0..31, d ∈ 1..255 —
// a fixed-base mul is ≤ 31 additions (thread-safe lazy build: magic static)
static const std::vector<G1>& gen_table() {
  static const std::vector<G1> table = [] {
    std::vector<G1> t(32 * 255);
    G1 base;
    load_gen(base);
    for (int w = 0; w < 32; ++w) {
      t[w * 255] = base;
      for (int d = 2; d <= 255; ++d)
        g1_add(t[w * 255 + d - 2], base, t[w * 255 + d - 1]);
      for (int i = 0; i < 8; ++i) g1_double(base, base);
    }
    return t;
  }();
  return table;
}

static void g1_mul_gen(const u64* kraw4, G1& o) {
  const std::vector<G1>& t = gen_table();
  o.inf = true;
  for (int w = 0; w < 32; ++w) {
    int d = (int)((kraw4[w / 8] >> ((w % 8) * 8)) & 0xFF);
    if (d) g1_add(o, t[w * 255 + d - 1], o);
  }
}

// per-call window-4 table for an arbitrary base (used by the batched TPKE
// encrypt for pk^r: 960 build adds amortize over the batch, 63 adds/mul)
struct G1Win4 {
  std::vector<G1> t;  // [w·15 + d−1] = [d·2^{4w}]·P, w ∈ 0..63
  void build(const G1& p) {
    t.resize(64 * 15);
    G1 base = p;
    for (int w = 0; w < 64; ++w) {
      t[w * 15] = base;
      for (int d = 2; d <= 15; ++d)
        g1_add(t[w * 15 + d - 2], base, t[w * 15 + d - 1]);
      for (int i = 0; i < 4; ++i) g1_double(base, base);
    }
  }
  void mul(const u64* kraw4, G1& o) const {
    o.inf = true;
    for (int w = 0; w < 64; ++w) {
      int d = (int)((kraw4[w / 16] >> ((w % 16) * 4)) & 0xF);
      if (d) g1_add(o, t[w * 15 + d - 1], o);
    }
  }
};

// ---------------------------------------------------------------------------
// serialization (host format: tag byte + big-endian affine coords)
// ---------------------------------------------------------------------------

static void fp_to_be48(const u64* m, uint8_t* out) {
  u64 raw[6];
  FP.to_raw(m, raw);
  for (int i = 0; i < 6; ++i) {
    u64 limb = raw[5 - i];
    for (int b = 0; b < 8; ++b) out[i * 8 + b] = (uint8_t)(limb >> (56 - 8 * b));
  }
}

static void fp_from_be48(const uint8_t* in, u64* out) {
  u64 raw[6] = {0};
  for (int i = 0; i < 6; ++i) {
    u64 limb = 0;
    for (int b = 0; b < 8; ++b) limb = (limb << 8) | in[i * 8 + b];
    raw[5 - i] = limb;
  }
  FP.from_raw(raw, out);
}

static void g1_write(const G1& pt, uint8_t* out97) {
  G1 a;
  g1_affine(pt, a);
  if (a.inf) {
    memset(out97, 0, 97);
    out97[0] = 0x40;
    return;
  }
  out97[0] = 0;
  fp_to_be48(a.x, out97 + 1);
  fp_to_be48(a.y, out97 + 49);
}

static bool g1_read(const uint8_t* in97, G1& o) {
  if (in97[0] == 0x40) {
    o.inf = true;
    return true;
  }
  if (in97[0] != 0) return false;
  o.inf = false;
  fp_from_be48(in97 + 1, o.x);
  fp_from_be48(in97 + 49, o.y);
  memcpy(o.z, FP.one, sizeof(FP.one));
  return true;
}

static void g2_write(const G2& pt, uint8_t* out193) {
  G2 a;
  g2_affine(pt, a);
  if (a.inf) {
    memset(out193, 0, 193);
    out193[0] = 0x40;
    return;
  }
  out193[0] = 0;
  fp_to_be48(a.x.a, out193 + 1);
  fp_to_be48(a.x.b, out193 + 49);
  fp_to_be48(a.y.a, out193 + 97);
  fp_to_be48(a.y.b, out193 + 145);
}

static bool g2_read(const uint8_t* in193, G2& o) {
  if (in193[0] == 0x40) {
    o.inf = true;
    return true;
  }
  if (in193[0] != 0) return false;
  o.inf = false;
  fp_from_be48(in193 + 1, o.x.a);
  fp_from_be48(in193 + 49, o.x.b);
  fp_from_be48(in193 + 97, o.y.a);
  fp_from_be48(in193 + 145, o.y.b);
  o.z = FP2_ONE_;
  return true;
}

// -- batch affine writes ----------------------------------------------------
// Montgomery batch inversion: one field inversion (a ~381-bit pow) + 3(m−1)
// muls replaces m inversions.  The batch TPKE entry points spend ~10 % of
// their time in per-point affine pow-inversions without this.

// Inputs to both batch-inversion chains MUST be nonzero: one zero element
// would zero every prefix product and silently corrupt the WHOLE batch
// (the old per-point path corrupted only its own output).  Callers uphold
// this by filtering infinity points (the only source of z = 0) before the
// chain; the guard makes a future caller that forgets fail loudly.

static void batch_inv_zero_guard(const u64* limbs, int n, const char* who) {
  for (int i = 0; i < n; ++i)
    if (limbs[i]) return;
  std::fprintf(stderr,
               "hbbft native: %s got a zero element — inputs must be "
               "nonzero (filter infinity/z=0 points before the shared "
               "inversion chain)\n", who);
  std::abort();
}

static void fp_batch_inv(std::vector<std::array<u64, 6>>& vals) {
  int m = (int)vals.size();
  if (m == 0) return;
  for (auto& v : vals) batch_inv_zero_guard(v.data(), 6, "fp_batch_inv");
  std::vector<std::array<u64, 6>> pre(m);
  pre[0] = vals[0];
  for (int i = 1; i < m; ++i)
    FP.mul(pre[i - 1].data(), vals[i].data(), pre[i].data());
  u64 acc[6];
  FP.pow(pre[m - 1].data(), BLS_P_M2, 6, acc);
  for (int i = m - 1; i > 0; --i) {
    u64 vi[6];
    memcpy(vi, vals[i].data(), sizeof(vi));
    FP.mul(acc, pre[i - 1].data(), vals[i].data());
    FP.mul(acc, vi, acc);
  }
  memcpy(vals[0].data(), acc, sizeof(acc));
}

static void f2_batch_inv(std::vector<Fp2>& vals) {
  int m = (int)vals.size();
  if (m == 0) return;
  for (auto& v : vals) {
    u64 both[12];
    memcpy(both, v.a, sizeof(v.a));
    memcpy(both + 6, v.b, sizeof(v.b));
    batch_inv_zero_guard(both, 12, "f2_batch_inv");
  }
  std::vector<Fp2> pre(m);
  pre[0] = vals[0];
  for (int i = 1; i < m; ++i) f2_mul(pre[i - 1], vals[i], pre[i]);
  Fp2 acc;
  f2_inv(pre[m - 1], acc);
  for (int i = m - 1; i > 0; --i) {
    Fp2 vi = vals[i];
    f2_mul(acc, pre[i - 1], vals[i]);
    f2_mul(acc, vi, acc);
  }
  vals[0] = acc;
}

// Affine-write m G1 points with ONE shared inversion chain; outs[i] gets the
// same 97 bytes g1_write would produce.
static void g1_write_batch(const std::vector<G1>& pts,
                           const std::vector<uint8_t*>& outs) {
  int m = (int)pts.size();
  std::vector<std::array<u64, 6>> zs;
  std::vector<int> idx;
  zs.reserve(m);
  idx.reserve(m);
  for (int i = 0; i < m; ++i) {
    if (pts[i].inf) {
      memset(outs[i], 0, 97);
      outs[i][0] = 0x40;
    } else {
      std::array<u64, 6> z;
      memcpy(z.data(), pts[i].z, sizeof(z));
      zs.push_back(z);
      idx.push_back(i);
    }
  }
  fp_batch_inv(zs);
  for (size_t j = 0; j < idx.size(); ++j) {
    int i = idx[j];
    u64 zi2[6], x[6], y[6], t[6];
    FP.sqr(zs[j].data(), zi2);
    FP.mul(pts[i].x, zi2, x);
    FP.mul(pts[i].y, zi2, t);
    FP.mul(t, zs[j].data(), y);
    outs[i][0] = 0;
    fp_to_be48(x, outs[i] + 1);
    fp_to_be48(y, outs[i] + 49);
  }
}

// Affine-write m G1 points into one contiguous 97-byte-stride buffer with a
// shared inversion chain (the mask-serialization step of both batch decrypt
// entry points).
static std::vector<uint8_t> g1_write_contig(const std::vector<G1>& pts) {
  int m = (int)pts.size();
  std::vector<uint8_t> buf(97 * (size_t)m);
  std::vector<uint8_t*> outs(m);
  for (int i = 0; i < m; ++i) outs[i] = &buf[97 * (size_t)i];
  g1_write_batch(pts, outs);
  return buf;
}

static void g2_write_batch(const std::vector<G2>& pts,
                           const std::vector<uint8_t*>& outs) {
  int m = (int)pts.size();
  std::vector<Fp2> zs;
  std::vector<int> idx;
  zs.reserve(m);
  idx.reserve(m);
  for (int i = 0; i < m; ++i) {
    if (pts[i].inf) {
      memset(outs[i], 0, 193);
      outs[i][0] = 0x40;
    } else {
      zs.push_back(pts[i].z);
      idx.push_back(i);
    }
  }
  f2_batch_inv(zs);
  for (size_t j = 0; j < idx.size(); ++j) {
    int i = idx[j];
    Fp2 zi2, x, y, t;
    f2_sqr(zs[j], zi2);
    f2_mul(pts[i].x, zi2, x);
    f2_mul(pts[i].y, zi2, t);
    f2_mul(t, zs[j], y);
    outs[i][0] = 0;
    fp_to_be48(x.a, outs[i] + 1);
    fp_to_be48(x.b, outs[i] + 49);
    fp_to_be48(y.a, outs[i] + 97);
    fp_to_be48(y.b, outs[i] + 145);
  }
}

static void fr_from_be32(const uint8_t* in, u64* raw4) {
  for (int i = 0; i < 4; ++i) {
    u64 limb = 0;
    for (int b = 0; b < 8; ++b) limb = (limb << 8) | in[i * 8 + b];
    raw4[3 - i] = limb;
  }
}

// ---------------------------------------------------------------------------
// pairing (mirrors host: affine Miller over |x|, cube-of-ate final exp)
// ---------------------------------------------------------------------------

static void line_sparse(const Fp2& c0, const Fp2& c2, const Fp2& c3, Fp12& o) {
  for (int i = 0; i < 6; ++i) o.c[i] = FP2_ZERO_;
  o.c[0] = c0;
  o.c[2] = c2;
  o.c[3] = c3;
}

static void miller_loop(const std::vector<G1>& ps, const std::vector<G2>& qs,
                        Fp12& f) {
  f = f12_one();
  std::vector<G1> pa;
  std::vector<G2> qa;
  for (size_t i = 0; i < ps.size(); ++i) {
    if (ps[i].inf || qs[i].inf) continue;
    G1 a;
    g1_affine(ps[i], a);
    G2 b;
    g2_affine(qs[i], b);
    pa.push_back(a);
    qa.push_back(b);
  }
  if (pa.empty()) return;
  u64 xs = BLS_X_ABS;
  int top = 63;
  while (!((xs >> top) & 1)) --top;
  std::vector<G2> Rs = qa;
  Fp12 ln;
  for (int bit = top - 1; bit >= 0; --bit) {
    f12_sqr(f, f);
    for (size_t i = 0; i < pa.size(); ++i) {
      Fp2 lam, t, t2, c0, c2, c3;
      // λ = 3x² / 2y
      f2_sqr(Rs[i].x, t);
      f2_scal_small(t, 3, t);
      f2_add(Rs[i].y, Rs[i].y, t2);
      f2_inv(t2, t2);
      f2_mul(t, t2, lam);
      f2_mul(lam, Rs[i].x, c0);
      f2_sub(c0, Rs[i].y, c0);
      Fp2 lxp;
      memcpy(lxp.a, pa[i].x, sizeof(lxp.a));
      memset(lxp.b, 0, sizeof(lxp.b));
      f2_mul(lam, lxp, c2);
      f2_neg(c2, c2);
      memcpy(c3.a, pa[i].y, sizeof(c3.a));
      memset(c3.b, 0, sizeof(c3.b));
      line_sparse(c0, c2, c3, ln);
      f12_mul(f, ln, f);
      // R = 2R (affine)
      Fp2 x3, y3;
      f2_sqr(lam, x3);
      f2_add(Rs[i].x, Rs[i].x, t);
      f2_sub(x3, t, x3);
      f2_sub(Rs[i].x, x3, t);
      f2_mul(lam, t, y3);
      f2_sub(y3, Rs[i].y, y3);
      Rs[i].x = x3;
      Rs[i].y = y3;
      Rs[i].z = FP2_ONE_;
      Rs[i].inf = false;
    }
    if ((xs >> bit) & 1) {
      for (size_t i = 0; i < pa.size(); ++i) {
        Fp2 dx;
        f2_sub(Rs[i].x, qa[i].x, dx);
        if (f2_is_zero(dx)) {
          G2 s;
          g2_add(Rs[i], qa[i], s);
          g2_affine(s, Rs[i]);
          continue;
        }
        Fp2 lam, t, c0, c2, c3;
        f2_sub(Rs[i].y, qa[i].y, t);
        f2_inv(dx, lam);
        f2_mul(t, lam, lam);
        f2_mul(lam, qa[i].x, c0);
        f2_sub(c0, qa[i].y, c0);
        Fp2 lxp;
        memcpy(lxp.a, pa[i].x, sizeof(lxp.a));
        memset(lxp.b, 0, sizeof(lxp.b));
        f2_mul(lam, lxp, c2);
        f2_neg(c2, c2);
        memcpy(c3.a, pa[i].y, sizeof(c3.a));
        memset(c3.b, 0, sizeof(c3.b));
        line_sparse(c0, c2, c3, ln);
        f12_mul(f, ln, f);
        Fp2 x3, y3;
        f2_sqr(lam, x3);
        f2_sub(x3, Rs[i].x, x3);
        f2_sub(x3, qa[i].x, x3);
        f2_sub(Rs[i].x, x3, t);
        f2_mul(lam, t, y3);
        f2_sub(y3, Rs[i].y, y3);
        Rs[i].x = x3;
        Rs[i].y = y3;
      }
    }
  }
  Fp12 cj;
  f12_conj(f, cj);
  f = cj;  // x < 0
}

static void final_exp(const Fp12& in, Fp12& out) {
  Fp12 f, t0, t1;
  // easy: f^(p⁶−1) then ^(p²+1)
  f12_conj(in, t0);
  f12_inv(in, t1);
  f12_mul(t0, t1, f);
  f12_frob(f, 2, t0);
  f12_mul(t0, f, f);
  // hard
  u64 xm1 = BLS_X_ABS + 1;
  Fp12 t, s, u;
  f12_pow_u(f, &xm1, 1, t);
  f12_conj(t, t);
  f12_pow_u(t, &xm1, 1, t);
  f12_conj(t, t);  // t = f^((x−1)²)
  u64 ax = BLS_X_ABS;
  f12_pow_u(t, &ax, 1, s);
  f12_conj(s, s);
  f12_frob(t, 1, t0);
  f12_mul(s, t0, s);  // s = t^(x+p)
  // x² (127-bit)
  u128 xx = (u128)ax * ax;
  u64 x2[2] = {(u64)xx, (u64)(xx >> 64)};
  f12_pow_u(s, x2, 2, u);
  f12_frob(s, 2, t0);
  f12_conj(s, t1);
  f12_mul(t0, t1, t0);
  f12_mul(u, t0, u);  // u = s^(x²+p²−1)
  u64 three = 3;
  f12_pow_u(f, &three, 1, t0);
  f12_mul(u, t0, out);
}

static bool pairing_check_vec(const std::vector<G1>& ps,
                              const std::vector<G2>& qs) {
  Fp12 f, e;
  miller_loop(ps, qs, f);
  final_exp(f, e);
  return f12_is_one(e);
}

// ---------------------------------------------------------------------------
// hash to curve (mirrors host try-and-increment)
// ---------------------------------------------------------------------------

static void mod_p_from_be(const uint8_t* data, int len, u64* out_m) {
  // acc = Σ byte·256^i (big-endian) mod p, in Montgomery form
  u64 acc[6] = {0};
  for (int i = 0; i < len; ++i) {
    for (int d = 0; d < 8; ++d) FP.dbl_mod(acc);  // acc *= 256 (raw domain ok)
    u64 raw[6] = {data[i]};
    // raw add mod p
    u64 t[6];
    u64 carry = Mod<6>::raw_add(acc, raw, t);
    if (carry || Mod<6>::cmp(t, FP.p) >= 0) Mod<6>::raw_sub(t, FP.p, t);
    memcpy(acc, t, sizeof(t));
  }
  FP.from_raw(acc, out_m);
}

static void hash_prefixed(const char* prefix, uint32_t ctr,
                          const uint8_t* data, int64_t len, uint8_t* out32) {
  std::vector<uint8_t> buf;
  size_t pl = strlen(prefix);
  buf.resize(pl + 4 + len);
  memcpy(buf.data(), prefix, pl);
  buf[pl] = (uint8_t)(ctr >> 24);
  buf[pl + 1] = (uint8_t)(ctr >> 16);
  buf[pl + 2] = (uint8_t)(ctr >> 8);
  buf[pl + 3] = (uint8_t)ctr;
  memcpy(buf.data() + pl + 4, data, len);
  hbbft_sha3_256(buf.data(), (int64_t)buf.size(), out32);
}

static void hash_g2_point(const uint8_t* data, int64_t len, G2& out) {
  for (uint32_t ctr = 0;; ++ctr) {
    uint8_t h[4][32];
    hash_prefixed("HBBFT-H2G-c0", ctr, data, len, h[0]);
    hash_prefixed("HBBFT-H2G-c1", ctr, data, len, h[1]);
    hash_prefixed("HBBFT-H2G-c2", ctr, data, len, h[2]);
    hash_prefixed("HBBFT-H2G-c3", ctr, data, len, h[3]);
    uint8_t cat[64];
    Fp2 x;
    memcpy(cat, h[0], 32);
    memcpy(cat + 32, h[1], 32);
    mod_p_from_be(cat, 64, x.a);
    memcpy(cat, h[2], 32);
    memcpy(cat + 32, h[3], 32);
    mod_p_from_be(cat, 64, x.b);
    Fp2 rhs, t;
    f2_sqr(x, t);
    f2_mul(t, x, rhs);
    f2_add(rhs, B2_M, rhs);
    // QR pre-test: χ_Fp2(g) = jacobi(norm(g)) — losing try-and-increment
    // candidates cost ~µs instead of field exponentiations.  Same ctr is
    // selected as before (norm = 0 ⟺ rhs = 0 ⟺ y = 0, also rejected).
    u64 nrm[6], tb[6];
    FP.sqr(rhs.a, nrm);
    FP.sqr(rhs.b, tb);
    FP.add(nrm, tb, nrm);
    if (jacobi_m(nrm) != 1) continue;
    Fp2 y;
    if (!f2_sqrt(rhs, y) || f2_is_zero(y)) continue;
    uint8_t sg[32];
    hash_prefixed("HBBFT-H2G-sign", ctr, data, len, sg);
    if (sg[31] & 1) f2_neg(y, y);
    G2 pt;
    pt.inf = false;
    pt.x = x;
    pt.y = y;
    pt.z = FP2_ONE_;
    G2 cleared;
    g2_clear_cofactor(pt, cleared);  // ψ-based (mirrors host hash_g2)
    if (!cleared.inf) {
      out = cleared;
      return;
    }
  }
}

static void hash_g1_point(const uint8_t* data, int64_t len, G1& out) {
  for (uint32_t ctr = 0;; ++ctr) {
    uint8_t h0[32], h1[32];
    hash_prefixed("HBBFT-H1G-0", ctr, data, len, h0);
    hash_prefixed("HBBFT-H1G-1", ctr, data, len, h1);
    uint8_t cat[64];
    memcpy(cat, h0, 32);
    memcpy(cat + 32, h1, 32);
    u64 x[6];
    mod_p_from_be(cat, 64, x);
    u64 rhs[6], t[6];
    FP.sqr(x, t);
    FP.mul(t, x, rhs);
    FP.add(rhs, B1_M, rhs);
    if (jacobi_m(rhs) != 1) continue;  // QR pre-test (same ctr selected)
    u64 y[6];
    if (!fp_sqrt(rhs, y) || Mod<6>::is_zero(y)) continue;
    uint8_t sg[32];
    hash_prefixed("HBBFT-H1G-s", ctr, data, len, sg);
    if (sg[31] & 1) FP.neg(y, y);
    G1 pt;
    pt.inf = false;
    memcpy(pt.x, x, sizeof(x));
    memcpy(pt.y, y, sizeof(y));
    memcpy(pt.z, FP.one, sizeof(FP.one));
    G1 cleared;
    // effective cofactor 1−x (64-bit) in place of the 125-bit h₁ — the
    // standard G1 clearing (RFC 9380 §8.8.1); mirrors host hash_g1
    u64 heff = BLS_X_ABS + 1;
    g1_mul_limbs(pt, &heff, 1, cleared);
    if (!cleared.inf) {
      out = cleared;
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// Fr Lagrange
// ---------------------------------------------------------------------------

static void lagrange_at_zero(const uint32_t* idx, int count, u64 out[][4]) {
  // xs_i = idx_i + 1 (Montgomery); λ_i = Π_{j≠i} x_j / (x_j − x_i)
  std::vector<std::array<u64, 4>> xs(count);
  for (int i = 0; i < count; ++i) {
    u64 raw[4] = {(u64)idx[i] + 1, 0, 0, 0};
    FR.from_raw(raw, xs[i].data());
  }
  for (int i = 0; i < count; ++i) {
    u64 num[4], den[4];
    memcpy(num, FR.one, sizeof(num));
    memcpy(den, FR.one, sizeof(den));
    for (int j = 0; j < count; ++j) {
      if (j == i) continue;
      u64 d[4];
      FR.mul(num, xs[j].data(), num);
      FR.sub(xs[j].data(), xs[i].data(), d);
      FR.mul(den, d, den);
    }
    u64 dinv[4];
    FR.pow(den, BLS_R_M2, 4, dinv);
    FR.mul(num, dinv, out[i]);
  }
}

// ---------------------------------------------------------------------------
// Wire validation (mirrors crypto/bls12_381.py g1_from_bytes/g2_from_bytes:
// canonical coordinates, on-curve, r-order subgroup)
// ---------------------------------------------------------------------------

// Parse 48 big-endian bytes into Montgomery form; false if >= p.
static bool fp_canonical_from_be48(const uint8_t* in, u64* out) {
  u64 raw[6] = {0};
  for (int i = 0; i < 6; ++i) {
    u64 limb = 0;
    for (int b = 0; b < 8; ++b) limb = (limb << 8) | in[i * 8 + b];
    raw[5 - i] = limb;
  }
  if (Mod<6>::cmp(raw, BLS_P) >= 0) return false;
  FP.from_raw(raw, out);
  return true;
}

static bool g1_on_curve(const G1& p) {  // affine input (z = 1)
  if (p.inf) return true;
  u64 y2[6], x3[6];
  FP.sqr(p.y, y2);
  FP.sqr(p.x, x3);
  FP.mul(x3, p.x, x3);
  FP.add(x3, B1_M, x3);
  return Mod<6>::cmp(y2, x3) == 0;
}

static bool g2_on_curve(const G2& p) {  // affine input (z = 1)
  if (p.inf) return true;
  Fp2 y2, x3;
  f2_sqr(p.y, y2);
  f2_sqr(p.x, x3);
  f2_mul(x3, p.x, x3);
  f2_add(x3, B2_M, x3);
  return Mod<6>::cmp(y2.a, x3.a) == 0 && Mod<6>::cmp(y2.b, x3.b) == 0;
}

// Eigenvalue subgroup membership (on-curve input assumed; soundness notes
// at the exported bls_g1_in_subgroup/bls_g2_in_subgroup below).
static bool g1_subgroup_ok(const G1& p) {
  if (p.inf) return true;
  // φ(P) == [λ]P with λ = x²−1: [x²]P costs two sparse [|x|] ladders
  // (x has Hamming weight 6 → 6 adds each) instead of a dense 127-bit
  // ladder's ~64 adds, then one mixed subtraction of P.
  G1 phi, lam, xp;
  u64 xk = BLS_X_ABS;
  g1_mul_limbs(p, &xk, 1, xp);    // [|x|]P
  g1_mul_limbs(xp, &xk, 1, lam);  // [x²]P
  G1 negp = p;
  FP.neg(p.y, negp.y);
  g1_add(lam, negp, lam);        // [x²−1]P
  g1_endo(p, phi);
  // g1_eq via cross-multiplied Jacobians
  if (phi.inf != lam.inf) return false;
  if (phi.inf) return true;
  u64 z1z1[6], z2z2[6], a[6], b[6], t[6];
  FP.sqr(phi.z, z1z1);
  FP.sqr(lam.z, z2z2);
  FP.mul(phi.x, z2z2, a);
  FP.mul(lam.x, z1z1, b);
  if (Mod<6>::cmp(a, b) != 0) return false;
  FP.mul(phi.y, lam.z, t);
  FP.mul(t, z2z2, a);
  FP.mul(lam.y, phi.z, t);
  FP.mul(t, z1z1, b);
  return Mod<6>::cmp(a, b) == 0;
}

static bool g2_subgroup_ok(const G2& p) {
  if (p.inf) return true;
  G2 ps, xp;
  g2_psi(p, ps);
  g2_mul_xabs(p, xp);
  g2_neg_pt(xp, xp);  // [x]P (x < 0)
  if (ps.inf != xp.inf) return false;
  if (ps.inf) return true;
  Fp2 z1z1, z2z2, a, b, t;
  f2_sqr(ps.z, z1z1);
  f2_sqr(xp.z, z2z2);
  f2_mul(ps.x, z2z2, a);
  f2_mul(xp.x, z1z1, b);
  if (Mod<6>::cmp(a.a, b.a) != 0 || Mod<6>::cmp(a.b, b.b) != 0) return false;
  f2_mul(ps.y, xp.z, t);
  f2_mul(t, z2z2, a);
  f2_mul(xp.y, ps.z, t);
  f2_mul(t, z1z1, b);
  return Mod<6>::cmp(a.a, b.a) == 0 && Mod<6>::cmp(a.b, b.b) == 0;
}

// g1_read with the full wire checks — byte-for-byte the same accept set as
// the Python g1_from_bytes (0x40 = infinity; flag byte must otherwise be 0;
// coordinates canonical; on-curve; subgroup).
static bool g1_read_checked(const uint8_t* in97, G1& o) {
  if (in97[0] == 0x40) {
    // strict: the flag must be followed by all-zero bytes — no malleable
    // encodings of the identity on the validated wire (Python
    // g1_from_bytes enforces the same accept set)
    for (int i = 1; i < 97; ++i)
      if (in97[i]) return false;
    o.inf = true;
    return true;
  }
  if (in97[0] != 0) return false;
  o.inf = false;
  if (!fp_canonical_from_be48(in97 + 1, o.x)) return false;
  if (!fp_canonical_from_be48(in97 + 49, o.y)) return false;
  memcpy(o.z, FP.one, sizeof(FP.one));
  return g1_on_curve(o) && g1_subgroup_ok(o);
}

static bool g2_read_checked(const uint8_t* in193, G2& o) {
  if (in193[0] == 0x40) {
    for (int i = 1; i < 193; ++i)  // strict infinity: flag + zeros only
      if (in193[i]) return false;
    o.inf = true;
    return true;
  }
  if (in193[0] != 0) return false;
  o.inf = false;
  if (!fp_canonical_from_be48(in193 + 1, o.x.a)) return false;
  if (!fp_canonical_from_be48(in193 + 49, o.x.b)) return false;
  if (!fp_canonical_from_be48(in193 + 97, o.y.a)) return false;
  if (!fp_canonical_from_be48(in193 + 145, o.y.b)) return false;
  o.z = FP2_ONE_;
  return g2_on_curve(o) && g2_subgroup_ok(o);
}

}  // namespace bls

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

using namespace bls;

extern "C" {

int bls_g1_add(const uint8_t* a, const uint8_t* b, uint8_t* out) {
  init_all();
  G1 pa, pb, r;
  if (!g1_read(a, pa) || !g1_read(b, pb)) return -1;
  g1_add(pa, pb, r);
  g1_write(r, out);
  return 0;
}

// f(1), f(2), ..., f(count) for f with ncoeffs coefficients (32-byte
// big-endian each, below r, constant term first), by Horner's rule in
// Montgomery form; out: count 32-byte big-endian values.  The threshold
// key shares of a network of count nodes (SecretKeySet.secret_key_shares).
int bls_fr_poly_eval_range(const uint8_t* coeffs_be32, int ncoeffs, int count,
                           uint8_t* out_be32) {
  init_all();
  std::vector<std::array<u64, 4>> coeffs(ncoeffs);
  for (int k = 0; k < ncoeffs; ++k) {
    u64 raw[4];
    fr_from_be32(coeffs_be32 + 32 * k, raw);
    if (Mod<4>::cmp(raw, BLS_R) >= 0) return -1;
    FR.from_raw(raw, coeffs[k].data());
  }
  for (int i = 0; i < count; ++i) {
    u64 raw[4] = {(u64)i + 1, 0, 0, 0}, x[4], acc[4] = {0, 0, 0, 0};
    FR.from_raw(raw, x);
    for (int k = ncoeffs - 1; k >= 0; --k) {
      FR.mul(acc, x, acc);
      FR.add(acc, coeffs[k].data(), acc);
    }
    FR.to_raw(acc, raw);
    for (int l = 0; l < 4; ++l)
      for (int b = 0; b < 8; ++b)
        out_be32[32 * i + 8 * l + b] = (uint8_t)(raw[3 - l] >> (56 - 8 * b));
  }
  return 0;
}

int bls_g1_mul(const uint8_t* a, const uint8_t* scalar_be32, uint8_t* out) {
  init_all();
  G1 pa, r;
  if (!g1_read(a, pa)) return -1;
  u64 k[4];
  fr_from_be32(scalar_be32, k);
  // reduce mod r like the host (g1_mul takes k % R)
  u64 km[4], kr[4];
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  g1_mul_limbs(pa, kr, 4, r);
  g1_write(r, out);
  return 0;
}

int bls_g2_add(const uint8_t* a, const uint8_t* b, uint8_t* out) {
  init_all();
  G2 pa, pb, r;
  if (!g2_read(a, pa) || !g2_read(b, pb)) return -1;
  g2_add(pa, pb, r);
  g2_write(r, out);
  return 0;
}

int bls_g2_mul(const uint8_t* a, const uint8_t* scalar_be32, uint8_t* out) {
  init_all();
  G2 pa, r;
  if (!g2_read(a, pa)) return -1;
  u64 k[4], km[4], kr[4];
  fr_from_be32(scalar_be32, k);
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  g2_mul_limbs(pa, kr, 4, r);
  g2_write(r, out);
  return 0;
}

void bls_hash_g1(const uint8_t* msg, int64_t len, uint8_t* out) {
  init_all();
  G1 pt;
  hash_g1_point(msg, len, pt);
  g1_write(pt, out);
}

void bls_hash_g2(const uint8_t* msg, int64_t len, uint8_t* out) {
  init_all();
  G2 pt;
  hash_g2_point(msg, len, pt);
  g2_write(pt, out);
}

int bls_pairing_check(const uint8_t* g1s, const uint8_t* g2s, int n) {
  init_all();
  std::vector<G1> ps(n);
  std::vector<G2> qs(n);
  for (int i = 0; i < n; ++i) {
    if (!g1_read(g1s + 97 * i, ps[i])) return -1;
    if (!g2_read(g2s + 193 * i, qs[i])) return -1;
  }
  return pairing_check_vec(ps, qs) ? 1 : 0;
}

void bls_sign(const uint8_t* msg, int64_t len, const uint8_t* sk_be32,
              uint8_t* out_sig) {
  init_all();
  G2 h, sig;
  hash_g2_point(msg, len, h);
  u64 k[4], km[4], kr[4];
  fr_from_be32(sk_be32, k);
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  g2_mul_gls(h, kr, sig);  // h is a hash output → in G2
  g2_write(sig, out_sig);
}

int bls_verify(const uint8_t* pk97, const uint8_t* msg, int64_t len,
               const uint8_t* sig193) {
  init_all();
  G1 pk, g1neg;
  G2 sig, h;
  if (!g1_read(pk97, pk) || !g2_read(sig193, sig)) return -1;
  hash_g2_point(msg, len, h);
  G1 gen;
  gen.inf = false;
  FP.from_raw(BLS_G1_X, gen.x);
  FP.from_raw(BLS_G1_Y, gen.y);
  memcpy(gen.z, FP.one, sizeof(FP.one));
  g1neg = gen;
  FP.neg(gen.y, g1neg.y);
  std::vector<G1> ps = {g1neg, pk};
  std::vector<G2> qs = {sig, h};
  return pairing_check_vec(ps, qs) ? 1 : 0;
}

int bls_combine_g2(const uint32_t* idx, const uint8_t* shares193, int count,
                   uint8_t* out193) {
  init_all();
  std::vector<std::array<u64, 4>> lams(count);
  lagrange_at_zero(idx, count, reinterpret_cast<u64(*)[4]>(lams.data()));
  G2 acc;
  acc.inf = true;
  for (int i = 0; i < count; ++i) {
    G2 s, t;
    if (!g2_read(shares193 + 193 * i, s)) return -1;
    u64 lr[4];
    FR.to_raw(lams[i].data(), lr);
    g2_mul_gls(s, lr, t);  // shares are wire-subgroup-checked upstream
    g2_add(acc, t, acc);
  }
  g2_write(acc, out193);
  return 0;
}

int bls_combine_g1(const uint32_t* idx, const uint8_t* shares97, int count,
                   uint8_t* out97) {
  init_all();
  std::vector<std::array<u64, 4>> lams(count);
  lagrange_at_zero(idx, count, reinterpret_cast<u64(*)[4]>(lams.data()));
  G1 acc;
  acc.inf = true;
  for (int i = 0; i < count; ++i) {
    G1 s, t;
    if (!g1_read(shares97 + 97 * i, s)) return -1;
    u64 lr[4];
    FR.to_raw(lams[i].data(), lr);
    g1_mul_glv(s, lr, t);  // shares are wire-subgroup-checked upstream
    g1_add(acc, t, acc);
  }
  g1_write(acc, out97);
  return 0;
}

// -- TPKE (mirrors crypto/tc.py) --------------------------------------------

static void kdf_stream(const uint8_t* seed97, int64_t length, uint8_t* out) {
  int64_t done = 0;
  uint32_t ctr = 0;
  while (done < length) {
    uint8_t buf[101];
    memcpy(buf, seed97, 97);
    buf[97] = (uint8_t)(ctr >> 24);
    buf[98] = (uint8_t)(ctr >> 16);
    buf[99] = (uint8_t)(ctr >> 8);
    buf[100] = (uint8_t)ctr;
    uint8_t h[32];
    hbbft_sha3_256(buf, 101, h);
    int64_t take = length - done < 32 ? length - done : 32;
    memcpy(out + done, h, take);
    done += take;
    ++ctr;
  }
}

int bls_tpke_encrypt(const uint8_t* pk97, const uint8_t* msg, int64_t len,
                     const uint8_t* r_be32, uint8_t* out_u97, uint8_t* out_v,
                     uint8_t* out_w193) {
  init_all();
  G1 pk, u, mask;
  if (!g1_read(pk97, pk)) return -1;
  u64 k[4], km[4], kr[4];
  fr_from_be32(r_be32, k);
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  g1_mul_gen(kr, u);      // fixed-base table: ≤ 31 adds
  g1_mul_glv(pk, kr, mask);
  g1_write(u, out_u97);
  uint8_t mask_bytes[97];
  g1_write(mask, mask_bytes);
  std::vector<uint8_t> stream(len);
  kdf_stream(mask_bytes, len, stream.data());
  for (int64_t i = 0; i < len; ++i) out_v[i] = msg[i] ^ stream[i];
  // W = hash_g2("HBBFT-TPKE" + U + V)^r
  std::vector<uint8_t> hin(10 + 97 + len);
  memcpy(hin.data(), "HBBFT-TPKE", 10);
  memcpy(hin.data() + 10, out_u97, 97);
  memcpy(hin.data() + 107, out_v, len);
  G2 h, w;
  hash_g2_point(hin.data(), (int64_t)hin.size(), h);
  g2_mul_gls(h, kr, w);  // hash output → in G2
  g2_write(w, out_w193);
  return 0;
}

int bls_tpke_verify(const uint8_t* u97, const uint8_t* v, int64_t vlen,
                    const uint8_t* w193) {
  init_all();
  G1 u, gen;
  G2 w, h;
  if (!g1_read(u97, u) || !g2_read(w193, w)) return -1;
  std::vector<uint8_t> hin(10 + 97 + vlen);
  memcpy(hin.data(), "HBBFT-TPKE", 10);
  memcpy(hin.data() + 10, u97, 97);
  memcpy(hin.data() + 107, v, vlen);
  hash_g2_point(hin.data(), (int64_t)hin.size(), h);
  gen.inf = false;
  FP.from_raw(BLS_G1_X, gen.x);
  FP.from_raw(BLS_G1_Y, gen.y);
  memcpy(gen.z, FP.one, sizeof(FP.one));
  G1 uneg = u;
  if (!u.inf) FP.neg(u.y, uneg.y);
  std::vector<G1> ps = {uneg, gen};
  std::vector<G2> qs = {h, w};
  return pairing_check_vec(ps, qs) ? 1 : 0;
}

int bls_tpke_combine(const uint32_t* idx, const uint8_t* shares97, int count,
                     const uint8_t* v, int64_t vlen, uint8_t* out_msg) {
  init_all();
  uint8_t mask[97];
  if (bls_combine_g1(idx, shares97, count, mask) != 0) return -1;
  std::vector<uint8_t> stream(vlen);
  kdf_stream(mask, vlen, stream.data());
  for (int64_t i = 0; i < vlen; ++i) out_msg[i] = v[i] ^ stream[i];
  return 0;
}

// -- batch entry points (the HoneyBadger epoch hot loops: ONE ctypes call,
// GIL released for the whole batch, per-call tables amortized) --------------

// Encrypt `count` messages to one public key.  msgs: concatenated plaintext
// bytes; lens[i] their lengths; rs: count×32 big-endian scalars (< r, drawn
// by the caller's seeded RNG — byte-identical to per-item bls_tpke_encrypt
// with the same r).  out: per item U(97) ‖ W(193) ‖ V(len_i), concatenated.
int bls_tpke_encrypt_batch(const uint8_t* pk97, const uint8_t* msgs,
                           const int64_t* lens, int count, const uint8_t* rs,
                           uint8_t* out) {
  init_all();
  G1 pk;
  if (!g1_read(pk97, pk)) return -1;
  G1Win4 pk_tab;
  bool use_tab = count >= 64;  // build cost ~960 adds vs 63 adds/mul saved
  if (use_tab) pk_tab.build(pk);
  // pass 1: all U = g1^r and mask = pk^r ladders (Jacobian), then ONE
  // shared inversion chain writes every affine point — per-item pow
  // inversions were ~10 % of the batch
  std::vector<std::array<u64, 4>> krs(count);
  std::vector<G1> g1s(2 * count);
  std::vector<uint8_t> maskb(97 * (size_t)count);
  std::vector<uint8_t*> g1outs(2 * count);
  {
    uint8_t* op = out;
    for (int i = 0; i < count; ++i) {
      u64 k[4], km[4];
      fr_from_be32(rs + 32 * i, k);
      FR.from_raw(k, km);
      FR.to_raw(km, krs[i].data());
      g1_mul_gen(krs[i].data(), g1s[2 * i]);
      if (use_tab)
        pk_tab.mul(krs[i].data(), g1s[2 * i + 1]);
      else
        g1_mul_glv(pk, krs[i].data(), g1s[2 * i + 1]);
      g1outs[2 * i] = op;                      // U straight into out
      g1outs[2 * i + 1] = &maskb[97 * (size_t)i];
      op += 290 + lens[i];
    }
  }
  g1_write_batch(g1s, g1outs);
  // pass 2: V = msg ⊕ KDF(mask), W = hash_g2(U‖V)^r (Jacobian), then one
  // shared Fp2 inversion chain writes the W points
  std::vector<G2> ws(count);
  std::vector<uint8_t*> wouts(count);
  {
    const uint8_t* mp = msgs;
    uint8_t* op = out;
    for (int i = 0; i < count; ++i) {
      int64_t len = lens[i];
      uint8_t* u_out = op;
      uint8_t* v_out = op + 290;
      std::vector<uint8_t> stream(len);
      kdf_stream(&maskb[97 * (size_t)i], len, stream.data());
      for (int64_t j = 0; j < len; ++j) v_out[j] = mp[j] ^ stream[j];
      std::vector<uint8_t> hin(10 + 97 + len);
      memcpy(hin.data(), "HBBFT-TPKE", 10);
      memcpy(hin.data() + 10, u_out, 97);
      memcpy(hin.data() + 107, v_out, len);
      G2 h;
      hash_g2_point(hin.data(), (int64_t)hin.size(), h);
      g2_mul_gls(h, krs[i].data(), ws[i]);
      wouts[i] = op + 97;
      mp += len;
      op += 290 + len;
    }
  }
  g2_write_batch(ws, wouts);
  return 0;
}

// masks[i] = [s]·U_i — the master-scalar fold of batched TPKE decryption
// (crypto/batch.py::batch_tpke_decrypt host path).  U_i are wire-checked
// subgroup members; s raw big-endian 32 bytes.
int bls_tpke_mask_batch(const uint8_t* s_be32, const uint8_t* us97, int count,
                        uint8_t* out97s) {
  init_all();
  u64 k[4], km[4], kr[4];
  fr_from_be32(s_be32, k);
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  for (int i = 0; i < count; ++i) {
    G1 u, m;
    if (!g1_read(us97 + 97 * i, u)) return -1;
    g1_mul_glv(u, kr, m);
    g1_write(m, out97s + 97 * i);
  }
  return 0;
}

// Fast subgroup membership via endomorphism eigenvalues (assumes the point
// is already on the curve — the Python deserializers check that first).
//
// Soundness (gcd argument, quantities asserted in tests/test_endomorphism):
//  G2: ψ(P) = [x]P ⟹ [x²−t·x+p]P = [p−x]P = ∞ (char. eq. of ψ, t = x+1)
//      and p−x = h₁·r, so ord(P) | gcd(h₁·r, h₂·r) = r·gcd(h₁,h₂) = r.
//  G1: φ(P) = [λ]P ⟹ [λ²+λ+1]P = [r·k]P = ∞, ord(P) | r·gcd(h₁,k) = r.
// One small ladder (64/127-bit) replaces the full-width [r−1] check.
int bls_g1_in_subgroup(const uint8_t* p97) {
  init_all();
  G1 p;
  if (!g1_read(p97, p)) return -1;
  return g1_subgroup_ok(p) ? 1 : 0;
}

int bls_g2_in_subgroup(const uint8_t* p193) {
  init_all();
  G2 p;
  if (!g2_read(p193, p)) return -1;
  return g2_subgroup_ok(p) ? 1 : 0;
}

// Full batched TPKE decrypt with the master-scalar fold: out_i = V_i ⊕
// KDF([s]·U_i) — GLV ladders, KDF, and XOR in one call (GIL released).
// us: count×97; vs: concatenated V bytes with vlens[i] lengths; out: same
// layout as vs.
int bls_tpke_decrypt_batch(const uint8_t* s_be32, const uint8_t* us97,
                           const uint8_t* vs, const int64_t* vlens, int count,
                           uint8_t* out) {
  init_all();
  u64 k[4], km[4], kr[4];
  fr_from_be32(s_be32, k);
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  std::vector<G1> masks(count);
  for (int i = 0; i < count; ++i) {
    G1 u;
    if (!g1_read(us97 + 97 * i, u)) return -1;
    g1_mul_glv(u, kr, masks[i]);
  }
  std::vector<uint8_t> maskb = g1_write_contig(masks);
  const uint8_t* vp = vs;
  uint8_t* op = out;
  for (int i = 0; i < count; ++i) {
    int64_t len = vlens[i];
    std::vector<uint8_t> stream(len);
    kdf_stream(&maskb[97 * (size_t)i], len, stream.data());
    for (int64_t j = 0; j < len; ++j) op[j] = vp[j] ^ stream[j];
    vp += len;
    op += len;
  }
  return 0;
}

// Wire-validate + decrypt `count` TPKE ciphertext payloads in ONE call —
// the HoneyBadger epoch's parse and decrypt phases fused (GIL released for
// both).  Each payload is Ciphertext.to_bytes layout: U(97) ‖ W(193) ‖
// vlen(4, BE) ‖ V, with plens[i] the item's total length (vlen must be
// exactly plens[i] − 294; callers with trailing bytes use the per-item
// path).  Each item gets the FULL Ciphertext.from_bytes wire checks —
// canonical coordinates, on-curve, r-order subgroup for BOTH U and W —
// then out_i = V_i ⊕ KDF([s]·U_i) (the master-scalar decrypt fold).
// Returns 0, or i+1 if item i is malformed (caller re-parses that item on
// the Python path for the precise error).
int bls_tpke_check_decrypt_batch(const uint8_t* s_be32,
                                 const uint8_t* payloads,
                                 const int64_t* plens, int count,
                                 uint8_t* out) {
  init_all();
  u64 k[4], km[4], kr[4];
  fr_from_be32(s_be32, k);
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  std::vector<G1> masks(count);
  {
    const uint8_t* pp = payloads;
    for (int i = 0; i < count; ++i) {
      int64_t plen = plens[i];
      if (plen < 294) return i + 1;
      int64_t vlen = ((int64_t)pp[290] << 24) | ((int64_t)pp[291] << 16) |
                     ((int64_t)pp[292] << 8) | (int64_t)pp[293];
      if (vlen != plen - 294) return i + 1;
      G1 u;
      G2 w;
      if (!g1_read_checked(pp, u)) return i + 1;
      if (!g2_read_checked(pp + 97, w)) return i + 1;
      g1_mul_glv(u, kr, masks[i]);
      pp += plen;
    }
  }
  std::vector<uint8_t> maskb = g1_write_contig(masks);
  const uint8_t* pp = payloads;
  uint8_t* op = out;
  for (int i = 0; i < count; ++i) {
    int64_t vlen = plens[i] - 294;
    std::vector<uint8_t> stream(vlen);
    kdf_stream(&maskb[97 * (size_t)i], vlen, stream.data());
    for (int64_t j = 0; j < vlen; ++j) op[j] = pp[294 + j] ^ stream[j];
    pp += plens[i];
    op += vlen;
  }
  return 0;
}

// Hash `count` messages to G2 in one call — the host half of the SPLIT
// device encrypt (crypto/batch.py::batch_tpke_encrypt_device): the ladders
// (2×fixed-base G1, GLS G2) run as device MSMs while this hash-dominated
// phase stays on the host.  All affine writes share ONE Fp2 inversion
// chain; the GIL is released by ctypes for the whole batch, so the epoch
// pipeline's encrypt thread overlaps with device dispatches for real.
int bls_hash_g2_batch(const uint8_t* msgs, const int64_t* lens, int count,
                      uint8_t* out193s) {
  init_all();
  std::vector<G2> hs(count);
  std::vector<uint8_t*> outs(count);
  const uint8_t* mp = msgs;
  for (int i = 0; i < count; ++i) {
    hash_g2_point(mp, lens[i], hs[i]);
    outs[i] = out193s + 193 * (size_t)i;
    mp += lens[i];
  }
  g2_write_batch(hs, outs);
  return 0;
}

// Common-coin batch: out_bits[i] = parity(SHA3(g2_bytes([s]·H_G2(nonce_i))))
// — the master-scalar god-view fold of ThresholdSign (parallel/aba.py::
// coin_for), one call for a whole epoch's instance axis.
int bls_coin_batch(const uint8_t* s_be32, const uint8_t* nonces,
                   const int64_t* lens, int count, uint8_t* out_bits) {
  init_all();
  u64 k[4], km[4], kr[4];
  fr_from_be32(s_be32, k);
  FR.from_raw(k, km);
  FR.to_raw(km, kr);
  const uint8_t* np = nonces;
  for (int i = 0; i < count; ++i) {
    G2 h, sig;
    hash_g2_point(np, lens[i], h);
    g2_mul_gls(h, kr, sig);
    uint8_t sig_bytes[193], digest[32];
    g2_write(sig, sig_bytes);
    hbbft_sha3_256(sig_bytes, 193, digest);
    out_bits[i] = digest[0] & 1;
    np += lens[i];
  }
  return 0;
}

}  // extern "C"
