"""Systematic Vandermonde Reed–Solomon erasure coding.

Counterpart of ``hbbft_tpu/ops/rs.py``: the same encode matrix
(Vandermonde(total, data) normalised by the inverse of its top data×data
block, so the first ``data`` rows are the identity).
:class:`ReedSolomon` works over GF(2^8) (at most 256 shards, bit-exact with
the reference's crate); :class:`ReedSolomon16` over GF(2^16) for larger
networks (up to 65536 shards).  :func:`for_n_f` picks the field.

Two APIs share each coder:

- **tensors** (``encode``, ``reconstruct``; the batched RBC of
  ``parallel/rbc.py``): one bit-plane product on the data's device,
  batched over any leading axes;
- **host bytes** (``encode_np``, ``encode_into``, ``reconstruct_np``,
  ``reconstruct_data_np``; object mode's ``Broadcast``), through the
  erasure backend switch below.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.ops import gf16, gf256

# ---------------------------------------------------------------------------
# Erasure backend switch
# ---------------------------------------------------------------------------
#
# HBBFT_ERASURE_BACKEND selects the host coder API's engine:
#   native — AVX2 pshufb nibble tables over the cached matrix (gf256.cpp
#            in the native oracle; GF(2^8) only)
#   numpy  — cached bitmatrix-XOR schedule (packed bit-planes, CSE, tiling)
#   device — the bit-plane product over packed bits (gf256.bitplane_packed)
#            on the ``device`` the caller passes: on a CUDA device it is the
#            kernel csrc/bitplane.cu or raises (the reference's value ``jax``)
#   auto   — native when the oracle library loads, else numpy (default)
#
# All backends are byte-identical; the switch trades setup cost against
# per-byte throughput.

_BACKENDS = ("auto", "native", "numpy", "device")

# Per-backend work counters (bytes = shard bytes produced), counted under a
# lock: the node runtimes of one process code on their own pump threads.
STATS = {b: {"calls": 0, "bytes": 0} for b in ("native", "numpy", "device")}
_STATS_LOCK = threading.Lock()


def stats_snapshot():
    """Copy of the per-backend encode/decode work counters."""
    with _STATS_LOCK:
        return {b: dict(v) for b, v in STATS.items()}


# Decode-side artifacts are keyed by (matrix, erasure-pattern): the matrix
# identity is the per-coder cache instance, the pattern is the key tuple.
# The pattern space is C(n, f) — unbounded dicts would grow without limit
# under adversarial erasure churn, so every per-coder cache is a small LRU.
_DECODE_CACHE_MAX = 512

# Above this many matrix columns the numpy path skips the XOR-schedule
# compile (its greedy CSE scans all operand pairs per output row —
# quadratic in the bit-matrix density) and keeps the cached table matmul.
_SCHED_MAX_COLS = 64


class _Lru:
    """Tiny insertion-ordered LRU for per-coder compiled artifacts
    (decode matrices, XOR schedules, bit matrices).  ``get`` refreshes
    recency; ``put`` returns the value and evicts the oldest entries
    beyond ``maxsize``.  Safe across threads: one process's node runtimes
    share a coder of each shape (:func:`_shared_coder`)."""

    __slots__ = ("_d", "maxsize", "_lock")

    def __init__(self, maxsize: int = _DECODE_CACHE_MAX):
        from collections import OrderedDict

        self._d = OrderedDict()
        self.maxsize = maxsize
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
            return v

    def put(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
            return value

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d


_native_oracle = None
_native_checked = False


_native_lock = threading.Lock()


def _native():
    """The ctypes oracle, or None when the library can't build/load (the
    first caller loads it; a concurrent one waits for its verdict)."""
    global _native_oracle, _native_checked
    if not _native_checked:
        with _native_lock:
            if not _native_checked:
                try:
                    from hbbft_tpu_torch.native.oracle import get_oracle

                    _native_oracle = get_oracle()
                except Exception:
                    _native_oracle = None
                _native_checked = True
    return _native_oracle


def resolve_backend() -> str:
    """The effective erasure backend for this process."""
    mode = os.environ.get("HBBFT_ERASURE_BACKEND", "auto")
    if mode not in _BACKENDS:
        raise ValueError(
            f"HBBFT_ERASURE_BACKEND={mode!r}: want one of {_BACKENDS}"
        )
    if mode == "auto":
        return "native" if _native() is not None else "numpy"
    if mode == "native" and _native() is None:
        raise RuntimeError(
            "HBBFT_ERASURE_BACKEND=native but the oracle library "
            "failed to build/load"
        )
    return mode


def device_key(device) -> torch.device:
    """``device`` as the one key the coders' device caches use: a CUDA
    device without an index is the current one, so ``"cuda"``,
    ``torch.device("cuda")`` and ``cuda:0`` (when 0 is current) share a
    cached matrix (1.91 GB packed at N = 16384)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _bits_on(cache: _Lru, key, matrix: np.ndarray, to_bits, device):
    """The packed bit matrix of ``matrix`` (``gf256.pack_matrix`` of
    ``to_bits(matrix)``) on ``device``, cached per (key, device) in the
    coder's ``cache``."""
    dev = device_key(device)
    ck = (key, dev)
    bits = cache.get(ck)
    if bits is None:
        bits = cache.put(
            ck, gf256.pack_matrix(torch.from_numpy(to_bits(matrix)).to(dev))
        )
    return bits


def _count(backend: str, out: np.ndarray) -> np.ndarray:
    s = STATS[backend]
    with _STATS_LOCK:
        s["calls"] += 1
        s["bytes"] += int(out.shape[0]) * int(out.shape[1])
    return out


class ReedSolomon:
    """``ReedSolomon::new(data_shards, parity_shards)`` equivalent."""

    def __init__(self, data_shards: int, parity_shards: int):
        if data_shards < 1:
            raise ValueError("data_shards must be >= 1")
        if data_shards + parity_shards > 256:
            raise ValueError("total shards must be <= 256 over GF(2^8)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        V = gf256.vandermonde(self.total_shards, data_shards)
        top_inv = gf256.gf_inv_matrix_np(V[:data_shards])
        self.matrix = gf256.gf_matmul_np(V, top_inv)  # (total, data)
        assert np.array_equal(
            self.matrix[:data_shards], np.eye(data_shards, dtype=np.uint8)
        )
        self.parity_matrix = self.matrix[data_shards:]
        self._parity_bits = gf256.gf_matrix_to_bits(self.parity_matrix)
        self._decode_cache = _Lru()
        # the host API's compiled artifacts, built once per key and reused:
        # key → XorSchedule (numpy backend) / (key, device) → bit matrix
        # (device backend); decode-side keys carry the erasure pattern
        self._sched_cache = _Lru()
        self._bits_cache = _Lru()
        self._dev: dict = {}  # device → packed parity bits
        self._mat_dev: dict = {}  # device → encode matrix u8

    def __reduce__(self):
        # a pickled protocol carries the coder's shape, not its caches: the
        # caches hold device tensors, and the process's shared coder of that
        # shape rebuilds them on its own device
        return (_shared_coder, (type(self), self.data_shards, self.parity_shards))

    def _on(self, device) -> torch.Tensor:
        """The packed parity bit matrix on ``device``, made once a device
        (keyed by :func:`device_key`)."""
        dev = device_key(device)
        hit = self._dev.get(dev)
        if hit is None:
            hit = self._dev[dev] = gf256.pack_matrix(
                torch.from_numpy(self._parity_bits).to(dev))
        return hit

    def matrix_on(self, device) -> torch.Tensor:
        """The (total, data) uint8 encode matrix as a tensor on ``device``."""
        dev = device_key(device)
        hit = self._mat_dev.get(dev)
        if hit is None:
            hit = self._mat_dev[dev] = torch.from_numpy(self.matrix).to(dev)
        return hit

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """uint8 (..., data_shards, B) → (..., total_shards, B)."""
        if self.parity_shards == 0:
            return data
        d = data.transpose(-1, -2)  # (..., B, k): symbols on the minor axis
        parity = gf256.gf_apply_packed(d, self._on(data.device))
        return torch.cat([data, parity.transpose(-1, -2)], dim=-2)

    def _decode_matrix(self, use: Tuple[int, ...]) -> np.ndarray:
        """Inverse of the encode-matrix rows for the surviving shard set —
        the survivor-pattern Gauss–Jordan, LRU-cached per pattern."""
        dec = self._decode_cache.get(use)
        if dec is None:
            dec = self._decode_cache.put(
                use, gf256.gf_inv_matrix_np(self.matrix[list(use)])
            )
        return dec

    # ------------------------------------------------------------- host API
    def encode_np(self, data: np.ndarray, device="cuda") -> np.ndarray:
        """data (data_shards, B) uint8 → all shards (total_shards, B).
        ``device`` is read only by the ``device`` backend."""
        data = np.asarray(data, dtype=np.uint8)
        assert data.shape[0] == self.data_shards
        if self.parity_shards == 0:
            return data.copy()
        out = np.empty((self.total_shards, data.shape[1]), dtype=np.uint8)
        out[: self.data_shards] = data
        self.encode_into(out, device=device)
        return out

    def encode_into(self, shards: np.ndarray, device="cuda") -> np.ndarray:
        """Fill the parity rows of a contiguous (total, B) buffer in place.

        The zero-copy encode primitive: data rows are already where they
        belong, parity is written into the tail of the same allocation.
        """
        assert shards.shape[0] == self.total_shards
        if self.parity_shards:
            self._apply_matrix(
                ("parity",), self.parity_matrix, shards[: self.data_shards],
                out=shards[self.data_shards:], device=device,
            )
        return shards

    def verify_np(self, shards: np.ndarray, device="cuda") -> bool:
        """True iff parity shards are consistent with data shards."""
        shards = np.asarray(shards, dtype=np.uint8)
        return bool(np.array_equal(
            self.encode_np(shards[: self.data_shards], device=device), shards))

    def reconstruct_np(self, shards: Sequence[Optional[bytes]],
                       device="cuda") -> List[bytes]:
        """Fill in missing (None) shards; needs ≥ data_shards present.

        Mirrors ``ReedSolomon::reconstruct(&mut Vec<Option<_>>)``.
        """
        def decode(sub, use):
            dec = self._decode_matrix(tuple(use))
            data = self._apply_matrix(("dec", tuple(use)), dec, sub,
                                      device=device)
            return (
                self._apply_matrix(("full",), self.matrix, data,
                                   device=device)
                if self.parity_shards else data
            )

        return _reconstruct_optional(self, shards, decode)

    def reconstruct_data_np(self, survivors: np.ndarray,
                            use: Tuple[int, ...], device="cuda") -> np.ndarray:
        """(data, B) data shards from the survivor rows ``use``; both the
        inversion and the compiled apply are pattern-cached."""
        dec = self._decode_matrix(tuple(use))
        return self._apply_matrix(("dec", tuple(use)), dec, survivors,
                                  device=device)

    def _apply_matrix(self, key, matrix, data, out=None, device="cuda"):
        """Backend-dispatched constant-matrix apply with cached artifacts.

        ``key`` identifies the matrix in the per-coder caches (the matrix
        itself is never rebuilt, and neither is its compiled form).
        """
        data = np.ascontiguousarray(data, dtype=np.uint8)
        backend = resolve_backend()
        if backend == "native":
            out = _native().gf_matmul_simd(matrix, data, out=out)
        elif backend == "device":
            bits = _bits_on(self._bits_cache, key, matrix,
                            gf256.gf_matrix_to_bits, device)
            d = torch.from_numpy(data).to(bits.device)
            res = gf256.gf_apply_packed(d.T, bits).T.contiguous().cpu().numpy()
            if out is None:
                out = res
            else:
                out[:] = res
        else:
            sched = self._sched_cache.get(key)
            if sched is None:
                sched = self._sched_cache.put(
                    key,
                    gf256.build_xor_schedule(gf256.gf_matrix_to_bits(matrix)),
                )
            out = gf256.apply_xor_schedule(sched, data, out=out)
        return _count(backend, out)

    def decode_bits(self, use: Tuple[int, ...]) -> np.ndarray:
        """Constant bit matrix rebuilding the data shards from rows ``use``."""
        return gf256.gf_matrix_to_bits(self._decode_matrix(tuple(use)))

    def reconstruct(self, survivors: torch.Tensor, use: Tuple[int, ...]):
        """survivors: uint8 (..., data_shards, B), the shards at indices
        ``use`` in that order → (..., data_shards, B) data shards."""
        bits = torch.from_numpy(self.decode_bits(use))
        out = gf256.gf_apply_bitmatrix(survivors.transpose(-1, -2), bits)
        return out.transpose(-1, -2)


class ReedSolomon16:
    """Systematic Vandermonde RS over GF(2^16), for N > 256 networks.

    The construction of :class:`ReedSolomon` in the 65536-element field:
    shard symbols are u16 little-endian byte pairs, so a shard's length
    must be even.  The matrix is built in closed form
    (:func:`gf16.systematic_matrix`), in well under a second at 4096
    shards.  Host encode and decode, and the device encode."""

    def __init__(self, data_shards: int, parity_shards: int):
        if data_shards < 1:
            raise ValueError("data_shards must be >= 1")
        if data_shards + parity_shards > (1 << 16):
            raise ValueError("total shards must be <= 65536 over GF(2^16)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = gf16.systematic_matrix(self.total_shards, data_shards)
        if not np.array_equal(
            self.matrix[:data_shards], np.eye(data_shards, dtype=np.uint16)
        ):
            raise ValueError("not a systematic encode matrix")
        self.parity_matrix = self.matrix[data_shards:]
        # decode-side artifacts keyed by (matrix, erasure-pattern) — same
        # bounded-LRU policy as the GF(2^8) coder
        self._decode_cache = _Lru()
        self._sched_cache = _Lru()
        self._bits_cache = _Lru()
        # device → packed parity bits; device → encode matrix i32; each made
        # once a device, the matrix only for a caller that asks for it
        self._dev: dict = {}
        self._mat_dev: dict = {}

    __reduce__ = ReedSolomon.__reduce__

    @functools.cached_property
    def _parity_bits(self) -> np.ndarray:
        """The parity matrix as a host GF(2) bit matrix
        (:func:`gf16.gf_matrix_to_bits`), made at first use: the CPU's
        encode packs it; a CUDA device builds its packed matrix on the card
        (at N = 16384 this host matrix would be 15.3 GB)."""
        return gf16.gf_matrix_to_bits(self.parity_matrix)

    def _on(self, device) -> torch.Tensor:
        """The packed parity bit matrix on ``device``, made once a device
        (keyed by :func:`device_key`)."""
        dev = device_key(device)
        hit = self._dev.get(dev)
        if hit is None:
            if dev.type == "cuda":
                bits = gf16.parity_bits_packed(
                    torch.from_numpy(self.parity_matrix.astype(np.int32)).to(dev))
            else:
                bits = gf256.pack_matrix(torch.from_numpy(self._parity_bits))
            hit = self._dev[dev] = bits
        return hit

    def matrix_on(self, device) -> torch.Tensor:
        """The (total, data) encode matrix as int32 symbols on ``device``."""
        dev = device_key(device)
        hit = self._mat_dev.get(dev)
        if hit is None:
            hit = self._mat_dev[dev] = torch.from_numpy(
                self.matrix.astype(np.int32)).to(dev)
        return hit

    @staticmethod
    def _to_symbols(shards: np.ndarray) -> np.ndarray:
        B = shards.shape[-1]
        if B % 2:
            raise ValueError(f"GF(2^16) shards need an even byte length, got {B}")
        s = shards.reshape(*shards.shape[:-1], B // 2, 2).astype(np.uint16)
        return s[..., 0] | (s[..., 1] << 8)

    @staticmethod
    def _from_symbols(sym: np.ndarray) -> np.ndarray:
        lo = (sym & 0xFF).astype(np.uint8)
        hi = (sym >> 8).astype(np.uint8)
        return np.stack([lo, hi], axis=-1).reshape(*sym.shape[:-1], sym.shape[-1] * 2)

    def encode_np(self, data: np.ndarray) -> np.ndarray:
        """Host encode: data (data_shards, B) uint8 → (total_shards, B)."""
        data = np.asarray(data, dtype=np.uint8)
        assert data.shape[0] == self.data_shards
        if self.parity_shards == 0:
            return data.copy()
        parity = gf16.gf_matmul_np(self.parity_matrix, self._to_symbols(data))
        return np.concatenate([data, self._from_symbols(parity)], axis=0)

    def encode_into(self, shards: np.ndarray, device="cuda") -> np.ndarray:
        """Same in-place contract as :meth:`ReedSolomon.encode_into`.  The
        GF(2^16) encode is the host table product on every backend (as the
        reference's), so ``device`` is not read."""
        assert shards.shape[0] == self.total_shards
        if self.parity_shards:
            D = self._to_symbols(shards[: self.data_shards])
            parity = gf16.gf_matmul_np(self.parity_matrix, D)
            shards[self.data_shards:] = self._from_symbols(parity)
        return shards

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """uint8 (..., data_shards, B) → (..., total_shards, B), B even."""
        if self.parity_shards == 0:
            return data
        parity = gf16.gf_apply_packed(data, self._on(data.device))
        return torch.cat([data, parity], dim=-2)

    def decode_matrix(self, use: Tuple[int, ...]) -> np.ndarray:
        """Inverse of the encode-matrix rows of the surviving shards ``use``
        (the survivor-pattern Gauss–Jordan, cached per pattern)."""
        dec = self._decode_cache.get(use)
        if dec is None:
            dec = self._decode_cache.put(
                use, gf16.gf_inv_matrix_np(self.matrix[list(use)])
            )
        return dec

    def _apply_matrix(self, key, matrix, data, device="cuda"):
        """Backend-dispatched constant-matrix apply with cached artifacts.

        The native SIMD kernel is GF(2^8)-only, so ``native`` routes to the
        numpy path here (byte-identical).  The numpy path runs the GF(2^8)
        coder's bitmatrix-XOR schedule: a u16 symbol is its two
        little-endian bytes, so a (k, B) shard block becomes (2k, B/2)
        interleaved byte rows (row 2k = low bytes, row 2k+1 = high bytes of
        symbol row k — the ``k*16 + bit`` input numbering of
        :func:`gf16.gf_matrix_to_bits`).  Above ``_SCHED_MAX_COLS`` matrix
        columns the schedule compile is skipped and the log/exp table
        product is used.  ``device`` runs the GF(2^16) bit-plane product on
        that device.
        """
        data = np.ascontiguousarray(data, dtype=np.uint8)
        backend = resolve_backend()
        if backend == "device":
            bits = _bits_on(self._bits_cache, key, matrix,
                            gf16.gf_matrix_to_bits, device)
            d = torch.from_numpy(data).to(bits.device)
            out = gf16.gf_apply_packed(d, bits).contiguous().cpu().numpy()
        else:
            backend = "numpy"  # the native kernel is GF(2^8)-only
            k, B = data.shape
            r = matrix.shape[0]
            if matrix.shape[1] <= _SCHED_MAX_COLS:
                sched = self._sched_cache.get(key)
                if sched is None:
                    sched = self._sched_cache.put(
                        key,
                        gf256.build_xor_schedule(gf16.gf_matrix_to_bits(matrix)),
                    )
                half = B // 2
                d2 = data.reshape(k, half, 2).transpose(0, 2, 1).reshape(2 * k, half)
                r2 = gf256.apply_xor_schedule(sched, d2)
                out = np.ascontiguousarray(
                    r2.reshape(r, 2, half).transpose(0, 2, 1).reshape(r, B)
                )
            else:
                out = self._from_symbols(
                    gf16.gf_matmul_np(matrix, self._to_symbols(data))
                )
        return _count(backend, out)

    def reconstruct_data_np(self, survivors: np.ndarray, use: Tuple[int, ...],
                            device="cuda") -> np.ndarray:
        """(data, B) data shards from the survivor rows ``use`` (host): the
        pattern-cached inversion, then the backend's apply."""
        dec = self.decode_matrix(tuple(use))
        return self._apply_matrix(("dec", tuple(use)), dec, survivors,
                                  device=device)

    def reconstruct_np(self, shards: Sequence[Optional[bytes]],
                       device="cuda") -> List[bytes]:
        """Fill in missing (None) shards; needs ≥ data_shards present.
        Same contract as :meth:`ReedSolomon.reconstruct_np` (object mode's
        ``Broadcast`` decodes through it at N > 256)."""
        def decode(sub, use):
            return self.encode_np(self.reconstruct_data_np(sub, use,
                                                           device=device))

        return _reconstruct_optional(self, shards, decode, even_len=True)


def _reconstruct_optional(coder, shards, decode, even_len: bool = False):
    """Shared fill-in-missing-shards driver for both coders.

    ``decode(sub, use) -> full`` rebuilds all shards from the first
    data_shards survivors; validation (counts, lengths, the GF(2^16)
    even-length requirement) lives here exactly once.
    """
    present = [i for i, s in enumerate(shards) if s is not None]
    if len(present) < coder.data_shards:
        raise ValueError(
            f"too few shards: {len(present)} < {coder.data_shards}"
        )
    if len(shards) != coder.total_shards:
        raise ValueError("wrong shard count")
    shard_len = len(shards[present[0]])
    if (even_len and shard_len % 2) or any(
        len(shards[i]) != shard_len for i in present
    ):
        raise ValueError("inconsistent/odd shard lengths")
    use = tuple(present[: coder.data_shards])
    sub = np.stack(
        [np.frombuffer(shards[i], dtype=np.uint8) for i in use]
    )
    full = decode(sub, use)
    out: List[bytes] = []
    for i in range(coder.total_shards):
        if shards[i] is not None:
            out.append(bytes(shards[i]))
        else:
            out.append(full[i].tobytes())
    return out


@functools.lru_cache(maxsize=256)
def _shared_coder(cls, data_shards: int, parity_shards: int):
    """The process's one coder of a class and shape (what an unpickled
    coder becomes)."""
    return cls(data_shards, parity_shards)


def for_n_f(n: int, f: int):
    """The RBC coder for an (n, f) network: data = n−2f, parity = 2f —
    GF(2^8) up to 256 shards, GF(2^16) beyond."""
    cls = ReedSolomon if n <= 256 else ReedSolomon16
    return _shared_coder(cls, n - 2 * f, 2 * f)
