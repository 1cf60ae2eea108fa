"""Systematic Vandermonde Reed–Solomon erasure coding.

Counterpart of ``hbbft_tpu/ops/rs.py``: the same encode matrix
(Vandermonde(total, data) normalised by the inverse of its top data×data
block, so the first ``data`` rows are the identity), applied on the device
as one bit-plane product batched over any leading axes.
:class:`ReedSolomon` works over GF(2^8) (at most 256 shards, bit-exact with
the reference's crate); :class:`ReedSolomon16` over GF(2^16) for larger
networks (up to 65536 shards).  :func:`for_n_f` picks the field.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from hbbft_tpu_torch.ops import gf16, gf256

_DECODE_CACHE_MAX = 512


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
        self._decode_cache: dict = {}
        self._dev: dict = {}  # device → (parity bits f32, encode matrix u8)

    def _on(self, device):
        hit = self._dev.get(device)
        if hit is None:
            hit = self._dev[device] = (
                torch.from_numpy(self._parity_bits).to(device, torch.float32),
                torch.from_numpy(self.matrix).to(device),
            )
        return hit

    def matrix_on(self, device) -> torch.Tensor:
        """The (total, data) uint8 encode matrix as a tensor on ``device``."""
        return self._on(device)[1]

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """uint8 (..., data_shards, B) → (..., total_shards, B)."""
        if self.parity_shards == 0:
            return data
        d = data.transpose(-1, -2)  # (..., B, k): symbols on the minor axis
        parity = gf256.gf_apply_bitmatrix(d, self._on(data.device)[0])
        return torch.cat([data, parity.transpose(-1, -2)], dim=-2)

    def _decode_matrix(self, use: Tuple[int, ...]) -> np.ndarray:
        dec = self._decode_cache.get(use)
        if dec is None:
            if len(self._decode_cache) >= _DECODE_CACHE_MAX:
                self._decode_cache.clear()
            dec = self._decode_cache[use] = gf256.gf_inv_matrix_np(
                self.matrix[list(use)]
            )
        return dec

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
        self._decode_cache: dict = {}
        # device → (parity bits f32, encode matrix i32), made once per device
        self._dev: dict = {}

    @functools.cached_property
    def _parity_bits(self) -> np.ndarray:
        """The parity matrix as a host GF(2) bit matrix
        (:func:`gf16.gf_matrix_to_bits`), made at first use: the CPU's
        encode reads it, a CUDA device builds its own copy on the card."""
        return gf16.gf_matrix_to_bits(self.parity_matrix)

    def _on(self, device):
        hit = self._dev.get(device)
        if hit is None:
            mat = torch.from_numpy(self.matrix.astype(np.int32)).to(device)
            if mat.device.type == "cuda":
                bits = gf16.parity_bits_f32(mat[self.data_shards:])
            else:
                bits = torch.from_numpy(self._parity_bits).to(device, torch.float32)
            hit = self._dev[device] = (bits, mat)
        return hit

    def matrix_on(self, device) -> torch.Tensor:
        """The (total, data) encode matrix as int32 symbols on ``device``."""
        return self._on(device)[1]

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

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """uint8 (..., data_shards, B) → (..., total_shards, B), B even."""
        if self.parity_shards == 0:
            return data
        parity = gf16.gf_apply_bitmatrix(data, self._on(data.device)[0])
        return torch.cat([data, parity], dim=-2)

    def decode_matrix(self, use: Tuple[int, ...]) -> np.ndarray:
        """Inverse of the encode-matrix rows of the surviving shards ``use``
        (the survivor-pattern Gauss–Jordan, cached per pattern)."""
        dec = self._decode_cache.get(use)
        if dec is None:
            if len(self._decode_cache) >= _DECODE_CACHE_MAX:
                self._decode_cache.clear()
            dec = self._decode_cache[use] = gf16.gf_inv_matrix_np(
                self.matrix[list(use)]
            )
        return dec

    def reconstruct_data_np(self, survivors: np.ndarray, use: Tuple[int, ...]) -> np.ndarray:
        """(data, B) data shards from the survivor rows ``use`` (host): the
        decode matrix applied with :func:`gf16.gf_matmul_np`."""
        dec = self.decode_matrix(tuple(use))
        return self._from_symbols(gf16.gf_matmul_np(dec, self._to_symbols(survivors)))


@functools.lru_cache(maxsize=256)
def for_n_f(n: int, f: int):
    """The RBC coder for an (n, f) network: data = n−2f, parity = 2f —
    GF(2^8) up to 256 shards, GF(2^16) beyond."""
    if n <= 256:
        return ReedSolomon(n - 2 * f, 2 * f)
    return ReedSolomon16(n - 2 * f, 2 * f)
