"""ctypes loader for the C++ CPU oracle library (the port's copy of the
JAX package's native oracle; the library builds here on first use)."""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = os.path.join(_DIR, "libhbbft_native.so")

_oracle: Optional["NativeOracle"] = None
_oracle_lock = threading.Lock()


def _stale() -> bool:
    return not os.path.exists(_LIB) or (
        os.path.getmtime(_LIB)
        < max(
            os.path.getmtime(os.path.join(_DIR, f))
            for f in ("gf256.cpp", "keccak.cpp", "bls381.cpp",
                      "bls381_mont.S", "Makefile",
                      "gen_bls_constants.py",
                      os.path.join("..", "crypto", "bls12_381.py"))
        )
    )


def _build() -> None:
    """``make`` under an exclusive file lock, so processes that start
    together (test workers) build the library once instead of writing it
    concurrently."""
    with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            subprocess.run(
                ["make", "-s"], cwd=_DIR, check=True, capture_output=True,
                text=True,
            )


class NativeOracle:
    """Thin typed wrapper over the C ABI in gf256.cpp / keccak.cpp."""

    def __init__(self):
        if _stale():
            _build()
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.hbbft_gf_mul_bytes.argtypes = [u8p, u8p, u8p, ctypes.c_int64]
        lib.hbbft_gf_matmul.argtypes = [u8p, u8p, u8p] + [ctypes.c_int] * 3
        lib.hbbft_gf_matmul_simd.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ]
        lib.hbbft_gf_invert.argtypes = [u8p, u8p, ctypes.c_int]
        lib.hbbft_gf_invert.restype = ctypes.c_int
        lib.hbbft_rs_matrix.argtypes = [ctypes.c_int, ctypes.c_int, u8p]
        lib.hbbft_rs_matrix.restype = ctypes.c_int
        lib.hbbft_rs_encode.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, u8p,
        ]
        lib.hbbft_rs_encode.restype = ctypes.c_int
        lib.hbbft_rs_reconstruct.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, u8p, u8p,
        ]
        lib.hbbft_rs_reconstruct.restype = ctypes.c_int
        lib.hbbft_keccak_f1600.argtypes = [u64p]
        lib.hbbft_sha3_256.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.hbbft_sha3_256_batch.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i = ctypes.c_int
        i64 = ctypes.c_int64
        i64p = ctypes.POINTER(ctypes.c_int64)
        for name, args, res in [
            ("bls_g1_add", [u8p, u8p, u8p], i),
            ("bls_g1_mul", [u8p, u8p, u8p], i),
            ("bls_g2_add", [u8p, u8p, u8p], i),
            ("bls_g2_mul", [u8p, u8p, u8p], i),
            ("bls_hash_g1", [u8p, i64, u8p], None),
            ("bls_hash_g2", [u8p, i64, u8p], None),
            ("bls_pairing_check", [u8p, u8p, i], i),
            ("bls_sign", [u8p, i64, u8p, u8p], None),
            ("bls_verify", [u8p, u8p, i64, u8p], i),
            ("bls_combine_g2", [u32p, u8p, i, u8p], i),
            ("bls_combine_g1", [u32p, u8p, i, u8p], i),
            ("bls_tpke_encrypt", [u8p, u8p, i64, u8p, u8p, u8p, u8p], i),
            ("bls_tpke_verify", [u8p, u8p, i64, u8p], i),
            ("bls_tpke_combine", [u32p, u8p, i, u8p, i64, u8p], i),
            ("bls_tpke_encrypt_batch", [u8p, u8p, i64p, i, u8p, u8p], i),
            ("bls_tpke_mask_batch", [u8p, u8p, i, u8p], i),
            ("bls_coin_batch", [u8p, u8p, i64p, i, u8p], i),
            ("bls_hash_g2_batch", [u8p, i64p, i, u8p], i),
            ("bls_g1_in_subgroup", [u8p], i),
            ("bls_g2_in_subgroup", [u8p], i),
            ("bls_tpke_decrypt_batch", [u8p, u8p, u8p, i64p, i, u8p], i),
            ("bls_tpke_check_decrypt_batch", [u8p, u8p, i64p, i, u8p], i),
            ("bls_fr_poly_eval_range", [u8p, i, i, u8p], i),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        self._lib = lib

    @staticmethod
    def _p(a: np.ndarray):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def gf_mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(a, dtype=np.uint8)
        b = np.ascontiguousarray(b, dtype=np.uint8)
        out = np.empty_like(a)
        self._lib.hbbft_gf_mul_bytes(self._p(a), self._p(b), self._p(out), a.size)
        return out

    def gf_matmul(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        A = np.ascontiguousarray(A, dtype=np.uint8)
        B = np.ascontiguousarray(B, dtype=np.uint8)
        r, k = A.shape
        k2, c = B.shape
        assert k == k2
        out = np.empty((r, c), dtype=np.uint8)
        self._lib.hbbft_gf_matmul(self._p(A), self._p(B), self._p(out), r, k, c)
        return out

    def gf_matmul_simd(
        self, A: np.ndarray, B: np.ndarray, out: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """SIMD constant-matrix apply (AVX2 pshufb nibble tables).

        Hot-path variant of :meth:`gf_matmul`: ``A`` is the small CACHED
        encode/decode matrix, ``B`` the shard rows; ``out`` may be a view
        into the caller's allocation (e.g. the parity tail of one
        contiguous shard buffer) so encode writes in place with no copy.
        """
        r, k = A.shape
        cols = int(B.shape[1])
        assert A.flags.c_contiguous and B.flags.c_contiguous
        if out is None:
            out = np.empty((r, cols), dtype=np.uint8)
        assert out.flags.c_contiguous and out.shape == (r, cols)
        self._lib.hbbft_gf_matmul_simd(
            self._p(A), self._p(B), self._p(out), r, k, cols
        )
        return out

    def gf_invert(self, M: np.ndarray) -> np.ndarray:
        M = np.ascontiguousarray(M, dtype=np.uint8)
        n = M.shape[0]
        out = np.empty((n, n), dtype=np.uint8)
        rc = self._lib.hbbft_gf_invert(self._p(M), self._p(out), n)
        if rc != 0:
            raise np.linalg.LinAlgError("singular")
        return out

    def rs_matrix(self, data: int, total: int) -> np.ndarray:
        out = np.empty((total, data), dtype=np.uint8)
        rc = self._lib.hbbft_rs_matrix(data, total, self._p(out))
        if rc != 0:
            raise ValueError("bad rs dims")
        return out

    def rs_encode(self, data_shards: np.ndarray, total: int) -> np.ndarray:
        data_shards = np.ascontiguousarray(data_shards, dtype=np.uint8)
        k, B = data_shards.shape
        shards = np.zeros((total, B), dtype=np.uint8)
        shards[:k] = data_shards
        rc = self._lib.hbbft_rs_encode(k, total, B, self._p(shards))
        if rc != 0:
            raise ValueError("encode failed")
        return shards

    def rs_reconstruct(
        self, data: int, shards: Sequence[Optional[bytes]]
    ) -> List[bytes]:
        total = len(shards)
        present = np.array(
            [1 if s is not None else 0 for s in shards], dtype=np.uint8
        )
        if int(present.sum()) < data:
            raise ValueError("too few shards")
        shard_len = len(next(s for s in shards if s is not None))
        buf = np.zeros((total, shard_len), dtype=np.uint8)
        for i, s in enumerate(shards):
            if s is not None:
                buf[i] = np.frombuffer(s, dtype=np.uint8)
        rc = self._lib.hbbft_rs_reconstruct(
            data, total, shard_len, self._p(buf), self._p(present)
        )
        if rc == -1:
            raise ValueError("too few shards")
        if rc != 0:
            raise ValueError("reconstruct failed")
        return [buf[i].tobytes() for i in range(total)]

    def keccak_f1600(self, state: np.ndarray) -> np.ndarray:
        state = np.ascontiguousarray(state, dtype=np.uint64).copy()
        assert state.shape == (25,)
        self._lib.hbbft_keccak_f1600(
            state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        )
        return state

    def sha3_256(self, data: bytes) -> bytes:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        if arr.size == 0:
            arr = np.zeros(1, dtype=np.uint8)  # valid pointer; len passed as 0
        out = np.empty(32, dtype=np.uint8)
        self._lib.hbbft_sha3_256(self._p(arr), len(data), self._p(out))
        return out.tobytes()

    def sha3_256_batch(self, msgs: np.ndarray) -> np.ndarray:
        msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
        n, L = msgs.shape
        out = np.empty((n, 32), dtype=np.uint8)
        self._lib.hbbft_sha3_256_batch(self._p(msgs), n, L, self._p(out))
        return out


    # -- BLS12-381 full scheme (bls381.cpp) ---------------------------------
    # All points use the host serialization (G1: 97 bytes, G2: 193 bytes);
    # scalars are 32-byte big-endian.

    @staticmethod
    def _buf(n: int) -> np.ndarray:
        return np.zeros(n, dtype=np.uint8)

    @staticmethod
    def _arr(b: bytes) -> np.ndarray:
        return np.frombuffer(bytes(b), dtype=np.uint8)

    def bls_g1_add(self, a: bytes, b: bytes) -> bytes:
        out = self._buf(97)
        assert self._lib.bls_g1_add(self._p(self._arr(a)), self._p(self._arr(b)), self._p(out)) == 0
        return out.tobytes()

    def bls_fr_poly_eval_range(self, coeffs, count: int) -> list:
        """[f(1), …, f(count)] mod r for f's coefficients (each below r,
        constant term first)."""
        buf = self._arr(b"".join(c.to_bytes(32, "big") for c in coeffs))
        out = self._buf(32 * count)
        assert self._lib.bls_fr_poly_eval_range(
            self._p(buf), len(coeffs), count, self._p(out)) == 0
        raw = out.tobytes()
        return [int.from_bytes(raw[32 * i: 32 * i + 32], "big") for i in range(count)]

    def bls_g1_mul(self, a: bytes, k: int) -> bytes:
        out = self._buf(97)
        kb = self._arr(k.to_bytes(32, "big"))
        assert self._lib.bls_g1_mul(self._p(self._arr(a)), self._p(kb), self._p(out)) == 0
        return out.tobytes()

    def bls_g2_add(self, a: bytes, b: bytes) -> bytes:
        out = self._buf(193)
        assert self._lib.bls_g2_add(self._p(self._arr(a)), self._p(self._arr(b)), self._p(out)) == 0
        return out.tobytes()

    def bls_g2_mul(self, a: bytes, k: int) -> bytes:
        out = self._buf(193)
        kb = self._arr(k.to_bytes(32, "big"))
        assert self._lib.bls_g2_mul(self._p(self._arr(a)), self._p(kb), self._p(out)) == 0
        return out.tobytes()

    def bls_hash_g1(self, msg: bytes) -> bytes:
        out = self._buf(97)
        self._lib.bls_hash_g1(self._p(self._arr(msg or b"\0")), len(msg), self._p(out))
        return out.tobytes()

    def bls_hash_g2(self, msg: bytes) -> bytes:
        out = self._buf(193)
        self._lib.bls_hash_g2(self._p(self._arr(msg or b"\0")), len(msg), self._p(out))
        return out.tobytes()

    def bls_pairing_check(self, pairs) -> bool:
        n = len(pairs)
        g1s = np.concatenate([self._arr(p) for p, _ in pairs]) if n else self._buf(97)
        g2s = np.concatenate([self._arr(q) for _, q in pairs]) if n else self._buf(193)
        rc = self._lib.bls_pairing_check(self._p(g1s), self._p(g2s), n)
        assert rc >= 0
        return bool(rc)

    def bls_sign(self, msg: bytes, sk: int) -> bytes:
        out = self._buf(193)
        self._lib.bls_sign(
            self._p(self._arr(msg or b"\0")), len(msg),
            self._p(self._arr(sk.to_bytes(32, "big"))), self._p(out),
        )
        return out.tobytes()

    def bls_verify(self, pk: bytes, msg: bytes, sig: bytes) -> bool:
        rc = self._lib.bls_verify(
            self._p(self._arr(pk)), self._p(self._arr(msg or b"\0")),
            len(msg), self._p(self._arr(sig)),
        )
        assert rc >= 0
        return bool(rc)

    def _idx(self, indices):
        import ctypes

        arr = np.asarray(indices, dtype=np.uint32)
        return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))

    def bls_combine_g2(self, shares: dict) -> bytes:
        items = sorted(shares.items())
        keep, idxp = self._idx([i for i, _ in items])
        buf = np.concatenate([self._arr(s) for _, s in items])
        out = self._buf(193)
        assert self._lib.bls_combine_g2(idxp, self._p(buf), len(items), self._p(out)) == 0
        return out.tobytes()

    def bls_combine_g1(self, shares: dict) -> bytes:
        items = sorted(shares.items())
        keep, idxp = self._idx([i for i, _ in items])
        buf = np.concatenate([self._arr(s) for _, s in items])
        out = self._buf(97)
        assert self._lib.bls_combine_g1(idxp, self._p(buf), len(items), self._p(out)) == 0
        return out.tobytes()

    def bls_tpke_encrypt(self, pk: bytes, msg: bytes, r: int):
        u = self._buf(97)
        v = self._buf(max(len(msg), 1))
        w = self._buf(193)
        assert self._lib.bls_tpke_encrypt(
            self._p(self._arr(pk)), self._p(self._arr(msg or b"\0")),
            len(msg), self._p(self._arr(r.to_bytes(32, "big"))),
            self._p(u), self._p(v), self._p(w),
        ) == 0
        return u.tobytes(), v.tobytes()[: len(msg)], w.tobytes()

    def bls_tpke_verify(self, u: bytes, v: bytes, w: bytes) -> bool:
        rc = self._lib.bls_tpke_verify(
            self._p(self._arr(u)), self._p(self._arr(v or b"\0")),
            len(v), self._p(self._arr(w)),
        )
        assert rc >= 0
        return bool(rc)

    def bls_tpke_decrypt_share(self, u: bytes, sk: int) -> bytes:
        return self.bls_g1_mul(u, sk)

    def bls_tpke_combine(self, shares: dict, v: bytes) -> bytes:
        items = sorted(shares.items())
        keep, idxp = self._idx([i for i, _ in items])
        buf = np.concatenate([self._arr(s) for _, s in items])
        out = self._buf(max(len(v), 1))
        assert self._lib.bls_tpke_combine(
            idxp, self._p(buf), len(items),
            self._p(self._arr(v or b"\0")), len(v), self._p(out),
        ) == 0
        return out.tobytes()[: len(v)]

    def bls_tpke_encrypt_batch(self, pk: bytes, msgs, rs) -> list:
        """Encrypt many messages to one key in ONE native call (GIL released
        for the whole batch; fixed-base/window tables amortized inside).
        ``rs``: per-message scalars, byte-identical to per-item
        ``bls_tpke_encrypt`` with the same r.  Returns [(u, v, w)]."""
        lens = (ctypes.c_int64 * len(msgs))(*[len(m) for m in msgs])
        cat = self._arr(b"".join(msgs) or b"\0")
        rs_cat = self._arr(b"".join(r.to_bytes(32, "big") for r in rs))
        total = sum(290 + len(m) for m in msgs)
        out = self._buf(max(total, 1))
        assert self._lib.bls_tpke_encrypt_batch(
            self._p(self._arr(pk)), self._p(cat), lens, len(msgs),
            self._p(rs_cat), self._p(out),
        ) == 0
        res, off, ob = [], 0, out.tobytes()
        for m in msgs:
            res.append(
                (ob[off:off + 97], ob[off + 290:off + 290 + len(m)],
                 ob[off + 97:off + 290])
            )
            off += 290 + len(m)
        return res

    def bls_tpke_mask_batch(self, scalar: int, us) -> list:
        """[scalar]·U for each 97-byte U (the batched decrypt master-scalar
        fold) in one native call."""
        if not us:
            return []
        buf = np.concatenate([self._arr(u) for u in us])
        out = self._buf(97 * len(us))
        assert self._lib.bls_tpke_mask_batch(
            self._p(self._arr(scalar.to_bytes(32, "big"))),
            self._p(buf), len(us), self._p(out),
        ) == 0
        ob = out.tobytes()
        return [ob[i * 97:(i + 1) * 97] for i in range(len(us))]

    def bls_g1_in_subgroup(self, p: bytes) -> bool:
        rc = self._lib.bls_g1_in_subgroup(self._p(self._arr(p)))
        assert rc >= 0
        return bool(rc)

    def bls_g2_in_subgroup(self, p: bytes) -> bool:
        rc = self._lib.bls_g2_in_subgroup(self._p(self._arr(p)))
        assert rc >= 0
        return bool(rc)

    def bls_tpke_decrypt_batch(self, scalar: int, us, vs) -> list:
        """plaintexts[i] = vs[i] ⊕ KDF([scalar]·U_i) — the whole batched
        decrypt (GLV mask fold + KDF + XOR) in one native call."""
        if not us:
            return []
        ubuf = np.concatenate([self._arr(u) for u in us])
        vlens = (ctypes.c_int64 * len(vs))(*[len(v) for v in vs])
        vcat = self._arr(b"".join(vs) or b"\0")
        total = sum(len(v) for v in vs)
        out = self._buf(max(total, 1))
        # not inside an assert: under python -O a skipped call would return
        # silently-plausible all-zero plaintexts
        rc = self._lib.bls_tpke_decrypt_batch(
            self._p(self._arr(scalar.to_bytes(32, "big"))),
            self._p(ubuf), self._p(vcat), vlens, len(us), self._p(out),
        )
        if rc != 0:
            raise ValueError("bls_tpke_decrypt_batch failed (bad point?)")
        ob = out.tobytes()
        res, off = [], 0
        for v in vs:
            res.append(ob[off:off + len(v)])
            off += len(v)
        return res

    def bls_tpke_check_decrypt_batch(self, scalar: int, payloads):
        """Wire-validate (the full ``Ciphertext.from_bytes`` checks —
        canonical coordinates, on-curve, r-order subgroup for U and W) and
        decrypt many raw ciphertext payloads in ONE native call.  Returns
        the plaintext list, or None if some item failed validation (the
        caller re-parses per-item on the Python path for the precise
        error).  Payloads must be exact ``Ciphertext.to_bytes`` output
        (vlen == len − 294); hand anything else to the per-item path."""
        if not payloads:
            return []
        plens = (ctypes.c_int64 * len(payloads))(*[len(p) for p in payloads])
        cat = self._arr(b"".join(payloads))
        total = sum(len(p) - 294 for p in payloads)
        out = self._buf(max(total, 1))
        rc = self._lib.bls_tpke_check_decrypt_batch(
            self._p(self._arr(scalar.to_bytes(32, "big"))),
            self._p(cat), plens, len(payloads), self._p(out),
        )
        if rc != 0:
            return None
        ob = out.tobytes()
        res, off = [], 0
        for p in payloads:
            vlen = len(p) - 294
            res.append(ob[off:off + vlen])
            off += vlen
        return res

    def bls_hash_g2_batch(self, msgs) -> list:
        """H_G2(msg) for every message in ONE native call (GIL released;
        affine writes share one Fp2 inversion chain) — the host hash half
        of the split device encrypt.  Byte-identical to per-item
        ``bls_hash_g2``.  Returns 193-byte G2 encodings."""
        if not msgs:
            return []
        lens = (ctypes.c_int64 * len(msgs))(*[len(m) for m in msgs])
        cat = self._arr(b"".join(msgs) or b"\0")
        out = self._buf(193 * len(msgs))
        assert self._lib.bls_hash_g2_batch(
            self._p(cat), lens, len(msgs), self._p(out),
        ) == 0
        ob = out.tobytes()
        return [ob[i * 193:(i + 1) * 193] for i in range(len(msgs))]

    def bls_coin_batch(self, scalar: int, nonces) -> list:
        """parity(SHA3(g2_bytes([scalar]·H_G2(nonce)))) per nonce — a whole
        instance axis of common coins in one native call."""
        lens = (ctypes.c_int64 * len(nonces))(*[len(n) for n in nonces])
        cat = self._arr(b"".join(nonces) or b"\0")
        out = self._buf(max(len(nonces), 1))
        assert self._lib.bls_coin_batch(
            self._p(self._arr(scalar.to_bytes(32, "big"))),
            self._p(cat), lens, len(nonces), self._p(out),
        ) == 0
        return [bool(b) for b in out.tobytes()[: len(nonces)]]


def get_oracle() -> NativeOracle:
    """Build (if needed) and return the singleton oracle (once, whichever
    thread asks first)."""
    global _oracle
    if _oracle is None:
        with _oracle_lock:
            if _oracle is None:
                _oracle = NativeOracle()
    return _oracle
