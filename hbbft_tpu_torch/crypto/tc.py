"""``threshold_crypto``-compatible threshold BLS + TPKE.

Mirrors the API surface of the ``threshold_crypto`` crate the reference links
(SURVEY §2.2): ``SecretKey``/``PublicKey`` (plain BLS), ``SecretKeySet``/
``PublicKeySet``/``SecretKeyShare``/``PublicKeyShare``/``SignatureShare``
(threshold signatures — the common coin), ``Ciphertext``/``DecryptionShare``
(threshold encryption — HoneyBadger contributions), and ``Poly``/
``Commitment`` (the threshold polynomial behind a key set).  The port's
copy of the JAX package's module, with the bivariate DKG polynomial and its
commitment (``BivarPoly``/``BivarCommitment``) that ``crypto/batch.py``'s
DKG calls take.

Scheme (self-consistent; bit-compat with the Rust crate is not required):
 - public keys in G1 (``pk = g1^sk``), signatures in G2 (``σ = H_G2(m)^sk``),
   verification ``e(g1, σ) == e(pk, H)`` via a single product-pairing check.
 - threshold keys from a degree-t polynomial f over Fr: share i is f(i+1);
   t+1 shares Lagrange-interpolate at 0 (in the exponent for combination).
 - TPKE (Baek–Zheng style, as in ``threshold_crypto::Ciphertext{U,V,W}``):
   U = g1^r, V = m ⊕ KDF(pk^r), W = H_G2(U‖V)^r; validity
   ``e(g1, W) == e(U, H)``; decryption share i is U^{x_i} verified by
   ``e(share, H) == e(pk_i, W)``; t+1 shares interpolate U^{f(0)} = pk^r.

All randomness comes from caller-supplied ``random.Random`` instances —
protocols stay deterministic from a seed, as in the reference's test design.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from hbbft_tpu_torch.crypto import bls12_381 as c

R = c.R

# --------------------------------------------------------------------------
# Fr helpers
# --------------------------------------------------------------------------


def _lagrange_coeffs_at_zero(xs: Sequence[int]) -> List[int]:
    """λ_i(0) for interpolation points xs (distinct, nonzero mod r).

    At the points 1 … m (the shares of a network's first m nodes) λ_i(0) is
    (−1)^(i−1)·C(m, i), found in one pass; other point sets take the
    pairwise products, O(m²) multiplications."""
    m = len(xs)
    if list(xs) == list(range(1, m + 1)):
        coeffs, binom = [], 1
        for i in range(1, m + 1):
            binom = binom * (m - i + 1) // i  # C(m, i), exact
            coeffs.append((binom if i % 2 else -binom) % R)
        return coeffs
    coeffs = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = num * (-xj) % R
            den = den * (xi - xj) % R
        coeffs.append(num * pow(den, -1, R) % R)
    return coeffs


def master_secret_from_shares(shares) -> int:
    """f(0) interpolated from (index, scalar) share pairs.

    The god-view fold used by the batched simulator: combining shares of a
    common base point Lagrange-in-the-exponent equals one scalar-mul by
    this master secret.  Caller passes exactly the t+1 shares it would
    hand to ``combine_signatures``/``decrypt`` (same index convention:
    evaluation points are index+1)."""
    items = sorted(shares)
    lams = _lagrange_coeffs_at_zero([i + 1 for i, _ in items])
    return sum(lam * x for (_, x), lam in zip(items, lams)) % R


def _kdf_stream(seed: bytes, length: int) -> bytes:
    """SHA3-256(seed ‖ ctr) for ctr = 0, 1, … (4-byte big-endian),
    concatenated and cut to ``length`` bytes — one join, linear time."""
    blocks = (length + 31) // 32
    return b"".join(
        hashlib.sha3_256(seed + ctr.to_bytes(4, "big")).digest()
        for ctr in range(blocks)
    )[:length]


def _xor_mask(data: bytes, seed: bytes) -> bytes:
    """``data`` XOR the KDF stream of ``seed``, as one big-int XOR."""
    n = len(data)
    stream = _kdf_stream(seed, n)
    return (int.from_bytes(data, "big") ^ int.from_bytes(stream, "big")).to_bytes(n, "big")


def _hash_ciphertext_point(u, v: bytes):
    return c.hash_g2(b"HBBFT-TPKE" + c.g1_to_bytes(u) + v)


def tpke_encrypt_batch(
    pk: "PublicKey", msgs: Sequence[bytes], rng,
    backend: Optional[str] = None, device="cuda",
) -> List["Ciphertext"]:
    """Encrypt many contributions to one threshold key.

    Draws one scalar per message from ``rng`` and is byte-identical to
    sequential ``pk.encrypt(msg, rng)`` calls regardless of backend
    (tests assert it).  ``backend`` (default: env HBBFT_ENCRYPT_BACKEND,
    then "auto"):

    - ``"native"``: the WHOLE batch is one C call — GIL released
      throughout, so the epoch pipeline's encrypt-ahead thread overlaps
      with device work for real (parallel/qhb.py); per-item cost is the
      endomorphism fast paths (fixed-base U, windowed pk^r, ψ-based
      hash-to-G2, GLS W).  Falls back to per-item Python if the oracle is
      unavailable.
    - ``"device"``: the SPLIT path — 2×G1 + GLS-G2 ladders for all
      proposers as device MSM dispatches, hash-to-G2 in a native batch
      call, chunk-pipelined so the host hash overlaps the device ladders
      (:func:`hbbft_tpu_torch.crypto.batch.batch_tpke_encrypt_device`),
      on ``device``.
    - ``"auto"``: device only on a CUDA ``device`` with no native oracle
      (see :func:`hbbft_tpu_torch.crypto.batch.device_encrypt_worthwhile`).

    This is the batched-device-encrypt lever of SURVEY §3.1's HOT encrypt
    row."""
    import os

    rs = [rng.randrange(1, R) for _ in msgs]
    if backend is None:
        backend = os.environ.get("HBBFT_ENCRYPT_BACKEND") or "auto"
    if backend not in ("auto", "native", "device"):
        raise ValueError(
            f"HBBFT_ENCRYPT_BACKEND={backend!r}: expected "
            "'auto', 'native' or 'device'"
        )
    if backend != "native":
        from hbbft_tpu_torch.crypto import batch as _batch

        if backend == "device" or _batch.device_encrypt_worthwhile(
            len(msgs), device
        ):
            return _batch.batch_tpke_encrypt_device(
                pk.point, msgs, rs, device=device
            )
    nat = c._native()
    if nat is not None:
        out = nat.bls_tpke_encrypt_batch(
            pk.to_bytes(), [bytes(m) for m in msgs], rs
        )
        return [
            Ciphertext(
                c._g1_from_bytes_trusted(u), v, c._g2_from_bytes_trusted(w)
            )
            for (u, v, w) in out
        ]
    return [pk._encrypt_with_r(m, r) for m, r in zip(msgs, rs)]


# --------------------------------------------------------------------------
# Plain keys (per-node; DHB votes, SyncKeyGen row encryption)
# --------------------------------------------------------------------------


class Signature:
    """BLS signature (G2).  ``parity()`` is the common-coin bit."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    def to_bytes(self) -> bytes:
        return c.g2_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(c.g2_from_bytes(data))

    def parity(self) -> bool:
        return bool(hashlib.sha3_256(self.to_bytes()).digest()[0] & 1)

    def __eq__(self, other):
        return isinstance(other, Signature) and c.g2_eq(self.point, other.point)

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"Signature({self.to_bytes()[:9].hex()}…)"


class SignatureShare(Signature):
    """One node's signature share (G2)."""


class PublicKey:
    """Plain BLS public key (G1)."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    def to_bytes(self) -> bytes:
        return c.g1_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        return cls(c.g1_from_bytes(data))

    def verify(self, sig: Signature, msg: bytes) -> bool:
        h = c.hash_g2(msg)
        return c.pairing_check(
            [(c.g1_neg(c.G1_GEN), sig.point), (self.point, h)]
        )

    def encrypt(self, msg: bytes, rng) -> "Ciphertext":
        """Hybrid encryption to this key (TPKE-shaped: (U, V, W))."""
        return self._encrypt_with_r(msg, rng.randrange(1, R))

    def _encrypt_with_r(self, msg: bytes, r: int) -> "Ciphertext":
        u = c.g1_mul(c.G1_GEN, r)
        mask = c.g1_mul(self.point, r)
        v = _xor_mask(msg, c.g1_to_bytes(mask))
        w = c.g2_mul(_hash_ciphertext_point(u, v), r)
        return Ciphertext(u, v, w)

    def __eq__(self, other):
        return isinstance(other, PublicKey) and c.g1_eq(self.point, other.point)

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"PublicKey({self.to_bytes()[:9].hex()}…)"

    def __lt__(self, other):  # stable ordering for membership maps
        return self.to_bytes() < other.to_bytes()


class PublicKeyShare(PublicKey):
    """Public counterpart of a secret key share."""

    def verify_decryption_share(self, share: "DecryptionShare", ct: "Ciphertext") -> bool:
        h = _hash_ciphertext_point(ct.u, ct.v)
        return c.pairing_check(
            [(c.g1_neg(share.point), h), (self.point, ct.w)]
        )


class SecretKey:
    """Plain BLS secret key (Fr scalar)."""

    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar % R

    @classmethod
    def random(cls, rng) -> "SecretKey":
        return cls(rng.randrange(1, R))

    @classmethod
    def from_value(cls, v: int) -> "SecretKey":
        return cls(v)

    def public_key(self) -> PublicKey:
        return PublicKey(c.g1_mul(c.G1_GEN, self.scalar))

    def sign(self, msg: bytes) -> Signature:
        return Signature(c.g2_mul(c.hash_g2(msg), self.scalar))

    def decrypt(self, ct: "Ciphertext") -> Optional[bytes]:
        if not ct.verify():
            return None
        mask = c.g1_mul(ct.u, self.scalar)
        return _xor_mask(ct.v, c.g1_to_bytes(mask))

    def __repr__(self):
        return "SecretKey(<redacted>)"


class SecretKeyShare(SecretKey):
    """One node's share x_i = f(i+1) of the master secret f(0)."""

    def sign(self, msg: bytes) -> SignatureShare:  # type: ignore[override]
        return SignatureShare(c.g2_mul(c.hash_g2(msg), self.scalar))

    def decrypt_share(
        self, ct: "Ciphertext", check: bool = True
    ) -> Optional["DecryptionShare"]:
        """Our share U^{x_i}.  ``check=False`` skips the (pairing-priced)
        CCA validity check when the caller already verified the ciphertext."""
        if check and not ct.verify():
            return None
        return DecryptionShare(c.g1_mul(ct.u, self.scalar))

    def public_key_share(self) -> PublicKeyShare:
        return PublicKeyShare(c.g1_mul(c.G1_GEN, self.scalar))

    def __repr__(self):
        return "SecretKeyShare(<redacted>)"


class Ciphertext:
    """TPKE ciphertext (U ∈ G1, V bytes, W ∈ G2).

    Reference: ``threshold_crypto::Ciphertext`` — HoneyBadger proposes these
    and validates them before accepting a contribution
    (``src/honey_badger/epoch_state.rs``).
    """

    __slots__ = ("u", "v", "w")

    def __init__(self, u, v: bytes, w):
        self.u = u
        self.v = v
        self.w = w

    def verify(self) -> bool:
        """CCA check: e(g1, W) == e(U, H_G2(U‖V))."""
        h = _hash_ciphertext_point(self.u, self.v)
        return c.pairing_check([(c.g1_neg(self.u), h), (c.G1_GEN, self.w)])

    def to_bytes(self) -> bytes:
        return (
            c.g1_to_bytes(self.u)
            + c.g2_to_bytes(self.w)
            + len(self.v).to_bytes(4, "big")
            + self.v
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Ciphertext":
        u = c.g1_from_bytes(data[:97])
        w = c.g2_from_bytes(data[97:290])
        vlen = int.from_bytes(data[290:294], "big")
        return cls(u, data[294 : 294 + vlen], w)

    def __eq__(self, other):
        return (
            isinstance(other, Ciphertext)
            and self.v == other.v
            and c.g1_eq(self.u, other.u)
            and c.g2_eq(self.w, other.w)
        )

    def __hash__(self):
        return hash(self.to_bytes())


class DecryptionShare:
    """U^{x_i} ∈ G1.  Reference: ``threshold_crypto::DecryptionShare``."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    def to_bytes(self) -> bytes:
        return c.g1_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, data: bytes) -> "DecryptionShare":
        return cls(c.g1_from_bytes(data))

    def __eq__(self, other):
        return isinstance(other, DecryptionShare) and c.g1_eq(
            self.point, other.point
        )

    def __hash__(self):
        return hash(self.to_bytes())


# --------------------------------------------------------------------------
# Polynomials over Fr and their G1 commitments (DKG substrate)
# --------------------------------------------------------------------------


class Poly:
    """Univariate polynomial over Fr.  Reference: ``threshold_crypto::Poly``."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs: Sequence[int]):
        self.coeffs = [x % R for x in coeffs]
        while len(self.coeffs) > 1 and self.coeffs[-1] == 0:
            self.coeffs.pop()

    @classmethod
    def random(cls, degree: int, rng) -> "Poly":
        return cls([rng.randrange(R) for _ in range(degree + 1)])

    @classmethod
    def constant(cls, v: int) -> "Poly":
        return cls([v])

    @classmethod
    def zero(cls) -> "Poly":
        return cls([0])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int) -> int:
        acc = 0
        for coef in reversed(self.coeffs):
            acc = (acc * x + coef) % R
        return acc

    def __add__(self, other: "Poly") -> "Poly":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = other.coeffs + [0] * (n - len(other.coeffs))
        return Poly([(x + y) % R for x, y in zip(a, b)])

    def commitment(self) -> "Commitment":
        return Commitment([c.g1_mul(c.G1_GEN, coef) for coef in self.coeffs])

    @classmethod
    def interpolate(cls, points: Sequence[Tuple[int, int]]) -> "Poly":
        """Lagrange interpolation through (x, y) pairs."""
        result = [0]
        for i, (xi, yi) in enumerate(points):
            basis = [1]
            denom = 1
            for j, (xj, _) in enumerate(points):
                if i == j:
                    continue
                # basis *= (X − xj)
                nxt = [0] * (len(basis) + 1)
                for k, bc in enumerate(basis):
                    nxt[k] = (nxt[k] - bc * xj) % R
                    nxt[k + 1] = (nxt[k + 1] + bc) % R
                basis = nxt
                denom = denom * (xi - xj) % R
            scale = yi * pow(denom, -1, R) % R
            if len(result) < len(basis):
                result += [0] * (len(basis) - len(result))
            for k, bc in enumerate(basis):
                result[k] = (result[k] + bc * scale) % R
        return cls(result)


class Commitment:
    """G1 commitment to a Poly (coefficient-wise g1^c).

    Reference: ``threshold_crypto::poly::Commitment``.
    """

    __slots__ = ("points",)

    def __init__(self, points):
        self.points = list(points)

    def degree(self) -> int:
        return len(self.points) - 1

    def evaluate(self, x: int):
        """Π points[k]^{x^k} — the commitment to poly(x)."""
        if x % R == 0:  # Horner collapses to the constant term
            return self.points[0]
        acc = None
        for pt in reversed(self.points):
            acc = c.g1_add(c.g1_mul(acc, x) if acc is not None else None, pt)
        return acc

    def __add__(self, other: "Commitment") -> "Commitment":
        n = max(len(self.points), len(other.points))
        a = self.points + [None] * (n - len(self.points))
        b = other.points + [None] * (n - len(other.points))
        return Commitment([c.g1_add(x, y) for x, y in zip(a, b)])

    def to_bytes(self) -> bytes:
        return b"".join(c.g1_to_bytes(p) for p in self.points)

    def __eq__(self, other):
        return (
            isinstance(other, Commitment)
            and len(self.points) == len(other.points)
            and all(c.g1_eq(a, b) for a, b in zip(self.points, other.points))
        )

    def __hash__(self):
        return hash(self.to_bytes())


class BivarPoly:
    """Symmetric bivariate polynomial over Fr, degree t in each variable.

    Reference: ``threshold_crypto::poly::BivarPoly`` — the DKG dealer's
    object in ``SyncKeyGen``.  Symmetry (c[i][j] == c[j][i]) is what lets
    node j cross-check node i's row against its own.
    """

    __slots__ = ("degree_", "coeffs")

    def __init__(self, degree: int, coeffs):
        self.degree_ = degree
        self.coeffs = coeffs  # (t+1)×(t+1) symmetric

    @classmethod
    def random(cls, degree: int, rng) -> "BivarPoly":
        t = degree
        m = [[0] * (t + 1) for _ in range(t + 1)]
        for i in range(t + 1):
            for j in range(i, t + 1):
                v = rng.randrange(R)
                m[i][j] = v
                m[j][i] = v
        return cls(t, m)

    def degree(self) -> int:
        return self.degree_

    def evaluate(self, x: int, y: int) -> int:
        acc = 0
        xp = 1
        for i in range(self.degree_ + 1):
            yp = 1
            for j in range(self.degree_ + 1):
                acc = (acc + self.coeffs[i][j] * xp % R * yp) % R
                yp = yp * y % R
            xp = xp * x % R
        return acc

    def row(self, x: int) -> Poly:
        """The univariate poly f(x, ·)."""
        out = []
        for j in range(self.degree_ + 1):
            acc = 0
            xp = 1
            for i in range(self.degree_ + 1):
                acc = (acc + self.coeffs[i][j] * xp) % R
                xp = xp * x % R
            out.append(acc)
        return Poly(out)

    def commitment(self) -> "BivarCommitment":
        return BivarCommitment(
            self.degree_,
            [
                [c.g1_mul(c.G1_GEN, v) for v in row]
                for row in self.coeffs
            ],
        )


class BivarCommitment:
    """G1 commitment matrix to a BivarPoly.

    Reference: ``threshold_crypto::poly::BivarCommitment``.
    """

    __slots__ = ("degree_", "points")

    def __init__(self, degree: int, points):
        self.degree_ = degree
        self.points = points

    def degree(self) -> int:
        return self.degree_

    def evaluate(self, x: int, y: int):
        # Horner in both variables: every scalar-mul is by the evaluation
        # point itself, never by a full-width power — and DKG evaluation
        # points are node indices, which g1_mul's small-scalar fast path
        # turns into a handful of Python group ops each
        acc = None
        for i in reversed(range(self.degree_ + 1)):
            row_acc = None
            for j in reversed(range(self.degree_ + 1)):
                row_acc = c.g1_add(
                    c.g1_mul(row_acc, y) if row_acc is not None else None,
                    self.points[i][j],
                )
            acc = c.g1_add(
                c.g1_mul(acc, x) if acc is not None else None, row_acc
            )
        return acc

    def row(self, x: int) -> Commitment:
        if x % R == 0:  # x^i vanishes for i > 0
            return Commitment(list(self.points[0]))
        out = []
        for j in range(self.degree_ + 1):
            # Horner over i: muls are by x itself (small for node indices)
            acc = None
            for i in reversed(range(self.degree_ + 1)):
                acc = c.g1_add(
                    c.g1_mul(acc, x) if acc is not None else None,
                    self.points[i][j],
                )
            out.append(acc)
        return Commitment(out)

    def to_bytes(self) -> bytes:
        return b"".join(
            c.g1_to_bytes(p) for row in self.points for p in row
        )

    def __eq__(self, other):
        return (
            isinstance(other, BivarCommitment)
            and self.degree_ == other.degree_
            and self.to_bytes() == other.to_bytes()
        )

    def __hash__(self):
        return hash(self.to_bytes())


# --------------------------------------------------------------------------
# Threshold key sets
# --------------------------------------------------------------------------


class PublicKeySet:
    """Threshold public key: commitment to the secret polynomial.

    Reference: ``threshold_crypto::PublicKeySet``.
    """

    __slots__ = ("commitment",)

    def __init__(self, commitment: Commitment):
        self.commitment = commitment

    def threshold(self) -> int:
        return self.commitment.degree()

    def public_key(self) -> PublicKey:
        return PublicKey(self.commitment.evaluate(0))

    def public_key_share(self, i: int) -> PublicKeyShare:
        return PublicKeyShare(self.commitment.evaluate(i + 1))

    def combine_signatures(
        self, shares: Mapping[int, SignatureShare]
    ) -> Signature:
        """Lagrange interpolation in the exponent over any t+1 shares."""
        if len(shares) < self.threshold() + 1:
            raise ValueError(
                f"need {self.threshold() + 1} shares, got {len(shares)}"
            )
        items = sorted(shares.items())[: self.threshold() + 1]
        xs = [i + 1 for i, _ in items]
        lams = _lagrange_coeffs_at_zero(xs)
        acc = None
        for (i, share), lam in zip(items, lams):
            acc = c.g2_add(acc, c.g2_mul(share.point, lam))
        return Signature(acc)

    def decrypt(
        self, shares: Mapping[int, DecryptionShare], ct: Ciphertext
    ) -> bytes:
        """Combine t+1 decryption shares and strip the mask."""
        if len(shares) < self.threshold() + 1:
            raise ValueError(
                f"need {self.threshold() + 1} shares, got {len(shares)}"
            )
        items = sorted(shares.items())[: self.threshold() + 1]
        xs = [i + 1 for i, _ in items]
        lams = _lagrange_coeffs_at_zero(xs)
        acc = None
        for (i, share), lam in zip(items, lams):
            acc = c.g1_add(acc, c.g1_mul(share.point, lam))
        mask = acc  # = pk^r
        return _xor_mask(ct.v, c.g1_to_bytes(mask))

    def verify_signature(self, sig: Signature, msg: bytes) -> bool:
        return self.public_key().verify(sig, msg)

    def verify_signature_share(
        self, i: int, share: SignatureShare, msg: bytes
    ) -> bool:
        return self.public_key_share(i).verify(share, msg)

    def to_bytes(self) -> bytes:
        return self.commitment.to_bytes()

    def __eq__(self, other):
        return isinstance(other, PublicKeySet) and self.commitment == other.commitment

    def __hash__(self):
        return hash(self.commitment)


class SecretKeySet:
    """Dealer-generated threshold secret: a random degree-t polynomial.

    Reference: ``threshold_crypto::SecretKeySet``.
    """

    __slots__ = ("poly",)

    def __init__(self, poly: Poly):
        self.poly = poly

    @classmethod
    def random(cls, threshold: int, rng) -> "SecretKeySet":
        return cls(Poly.random(threshold, rng))

    def threshold(self) -> int:
        return self.poly.degree()

    def secret_key_share(self, i: int) -> SecretKeyShare:
        return SecretKeyShare(self.poly.evaluate(i + 1))

    def secret_key_shares(self, count: int) -> List[SecretKeyShare]:
        """``secret_key_share(i)`` for i < count: the polynomial at 1 …
        count by Horner's rule in one native call (one share at a time
        without the native library)."""
        nat = c._native()
        if nat is None:
            return [self.secret_key_share(i) for i in range(count)]
        return [SecretKeyShare(v) for v in nat.bls_fr_poly_eval_range(self.poly.coeffs, count)]

    def public_keys(self) -> PublicKeySet:
        return PublicKeySet(self.poly.commitment())
