"""Systematic Vandermonde Reed–Solomon erasure coding over GF(2^8).

Counterpart of ``hbbft_tpu/ops/rs.py`` for networks of at most 256 shards:
the same encode matrix (Vandermonde(total, data) normalised by the inverse
of its top data×data block, so the first ``data`` rows are the identity),
applied on the device as one bit-plane product
(:func:`hbbft_tpu_torch.ops.gf256.gf_apply_bitmatrix`) batched over any
leading axes.  The GF(2^16) coder for N > 256 is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from hbbft_tpu_torch.ops import gf256

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


@functools.lru_cache(maxsize=256)
def for_n_f(n: int, f: int) -> ReedSolomon:
    """The RBC coder for an (n, f) network: data = n−2f, parity = 2f."""
    if n > 256:
        raise NotImplementedError(
            "N > 256 needs the GF(2^16) coder, which is not ported yet"
        )
    return ReedSolomon(n - 2 * f, 2 * f)
