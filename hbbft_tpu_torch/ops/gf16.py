"""GF(2^16) arithmetic — the erasure field for N > 256 networks, in PyTorch.

Counterpart of ``hbbft_tpu/ops/gf16.py``.  The reference's
``reed-solomon-erasure`` crate (and the GF(2^8) coder of
:mod:`hbbft_tpu_torch.ops.gf256`) caps total shards at 256, so larger
networks switch to GF(2^16) (poly x¹⁶+x¹²+x³+x+1 = 0x1100B, generator 2):
up to 65536 shards.

1. **Host (numpy)** — log/exp tables, matrix construction and inversion.
2. **Device (torch)** — a constant GF(2^16) matrix is GF(2)-linear, so
   applying it is one 0/1 matrix product on (16·k → 16·r) bit vectors
   (:func:`gf256.bitplane_packed`, over bits packed 32 a word); symbols
   are u16, stored as little-endian byte pairs in shards, so a packed data
   row is the symbols of one shard position across the shards, two a word,
   and the packed output is the parity symbols.  PyTorch's ``uint16`` has
   no ``>>`` on the CPU, so symbols and table indices live in int32/int64
   and turn into bytes only at the edges.
"""

from __future__ import annotations

import numpy as np
import torch

from hbbft_tpu_torch.ops import gf256

GF16_POLY = 0x1100B
GF16_GEN = 2
ORDER = 1 << 16

# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------


def _build_tables():
    exp = np.zeros(2 * ORDER, dtype=np.uint32)
    log = np.zeros(ORDER, dtype=np.int64)
    x = 1
    for i in range(ORDER - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & ORDER:
            x ^= GF16_POLY
    for i in range(ORDER - 1, 2 * ORDER):
        exp[i] = exp[i - (ORDER - 1)]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a, b):
    """Elementwise GF(2^16) multiply (numpy uint16-compatible arrays)."""
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    r = GF_EXP[(GF_LOG[a] + GF_LOG[b]) % (ORDER - 1)]
    return np.where((a != 0) & (b != 0), r, 0).astype(np.uint16)


def gf_inv(a):
    a = np.asarray(a)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(2^16) inverse of 0")
    return GF_EXP[(ORDER - 1) - GF_LOG[a]].astype(np.uint16)


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % (ORDER - 1)])


def gf_matmul_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^16) matrix product (host). A: (r, k), B: (k, c) → (r, c)."""
    A = np.asarray(A, dtype=np.uint16)
    B = np.asarray(B, dtype=np.uint16)
    r, k = A.shape
    assert k == B.shape[0]
    out = np.zeros((r, B.shape[1]), dtype=np.uint16)
    for i in range(k):
        out ^= gf_mul(A[:, i][:, None], B[i][None, :])
    return out


def gf_inv_matrix_np(M: np.ndarray) -> np.ndarray:
    """Gauss–Jordan inversion over GF(2^16) (host)."""
    M = np.asarray(M, dtype=np.uint16)
    n = M.shape[0]
    aug = np.concatenate([M.copy(), np.eye(n, dtype=np.uint16)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(2^16) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul(aug[col], gf_inv(aug[col, col]))
        mask = aug[:, col].copy()
        mask[col] = 0
        aug ^= gf_mul(mask[:, None], aug[col][None, :])
    return aug[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[r, c] = r^c, vectorized (0^0 = 1, as the coder takes it)."""
    r = np.arange(rows, dtype=np.int64)
    c = np.arange(cols, dtype=np.int64)
    expnt = (GF_LOG[r][:, None] * c[None, :]) % (ORDER - 1)
    V = GF_EXP[expnt].astype(np.uint16)
    V[0, :] = 0
    V[:, 0] = 1
    return V


def systematic_matrix(total: int, data: int) -> np.ndarray:
    """The systematic encode matrix ``V · V[:data]⁻¹`` of
    ``vandermonde(total, data)``, in closed form: (total, data) uint16.

    Row r of the product holds the Lagrange basis on the points
    x_c = c (c < data) evaluated at x_r = r, so the top block is the
    identity and, below it, ``M[r, c] = w_c · P(x_r) / (x_r ⊕ x_c)`` with
    ``P(x) = Π_j (x ⊕ x_j)`` and ``w_c = 1 / Π_{j≠c} (x_c ⊕ x_j)``.  In the
    log domain that is three gathers of ``GF_LOG`` over sums of indices,
    where the Gauss–Jordan construction is O(total·data²) lookups.  The
    systematic matrix of a given V is unique, so both give the same bits."""
    if not 1 <= data <= total <= ORDER:
        raise ValueError(f"need 1 <= data <= total <= {ORDER}, got ({total}, {data})")
    q = ORDER - 1
    c = np.arange(data, dtype=np.int64)
    r = np.arange(data, total, dtype=np.int64)
    # Σ_{j≠c} log(x_c ⊕ x_j): the diagonal adds GF_LOG[0] = 0
    log_w = -GF_LOG[c[:, None] ^ c[None, :]].sum(axis=1)
    log_rc = GF_LOG[r[:, None] ^ c[None, :]]  # (total − data, data), r ≠ c
    log_p = log_rc.sum(axis=1)
    parity = GF_EXP[(log_p[:, None] - log_rc + log_w[None, :]) % q].astype(np.uint16)
    return np.concatenate([np.eye(data, dtype=np.uint16), parity], axis=0)


def gf_matrix_to_bits(M: np.ndarray) -> np.ndarray:
    """(r, k) GF(2^16) matrix → (k·16, r·16) GF(2) bit matrix (int8).

    ``A[k·16+i, j·16+b]`` = bit b of ``gf_mul(M[j, k], 1 << i)``, bits
    LSB-first, so ``(bits(D) @ A) & 1`` applies M to symbol vectors D.
    """
    M = np.asarray(M, dtype=np.uint16)
    r, k = M.shape
    powers = (1 << np.arange(16)).astype(np.uint32)
    prod = gf_mul(M[:, :, None], powers[None, None, :])  # (r, k, 16)
    bits = (prod[..., None].astype(np.uint32) >> np.arange(16)) & 1
    A = bits.transpose(1, 2, 0, 3).reshape(k * 16, r * 16)
    return A.astype(np.int8)


# ---------------------------------------------------------------------------
# Device path (torch)
# ---------------------------------------------------------------------------

_DEV_TABLES: dict = {}


def _tables(device):
    """(exp int64 (2·ORDER,), log int64 (ORDER,), shifts int32 (16,)) on
    ``device``."""
    hit = _DEV_TABLES.get(device)
    if hit is None:
        hit = _DEV_TABLES[device] = (
            torch.from_numpy(GF_EXP.astype(np.int64)).to(device),
            torch.from_numpy(GF_LOG).to(device),
            torch.arange(16, dtype=torch.int32, device=device),
        )
    return hit


def gf_mul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^16) multiply of two runtime symbol tensors (any
    integer dtype holding values < 2^16) via log/exp gathers → int32."""
    exp, log, _ = _tables(a.device)
    ai, bi = a.long(), b.long()
    r = exp[(log[ai] + log[bi]) % (ORDER - 1)]
    return torch.where((ai != 0) & (bi != 0), r, 0).to(torch.int32)


def gf_inv_torch(a: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^16) inverse → int32; maps 0 → 0 (caller masks)."""
    exp, log, _ = _tables(a.device)
    ai = a.long()
    r = exp[(ORDER - 1) - log[ai]]
    return torch.where(ai != 0, r, 0).to(torch.int32)


def gf_inv_matrix_torch(M: torch.Tensor) -> tuple:
    """Batched GF(2^16) matrix inversion: (..., n, n) symbols → (inv int32,
    ok) — the field-generic Gauss–Jordan of ``gf256`` (first-nonzero
    pivot), bit-identical to :func:`gf_inv_matrix_np`."""
    return gf256.gf_inv_matrix_impl(M, gf_mul_torch, gf_inv_torch, torch.int32)


def gf_matrix_to_bits_torch(M: torch.Tensor) -> torch.Tensor:
    """Batched :func:`gf_matrix_to_bits`: (..., r, k) symbols → int8
    (..., k*16, r*16), same layout as the host function."""
    r, k = M.shape[-2:]
    shifts = _tables(M.device)[2]
    prod = gf_mul_torch(M[..., None], 1 << shifts)  # (..., r, k, 16)
    bits = (prod[..., None] >> shifts) & 1  # (..., r, k, i, b)
    A = bits.movedim(-4, -2)  # (..., k, i, r, b)
    return A.reshape(*M.shape[:-2], k * 16, r * 16).to(torch.int8)


def parity_bits_f32(M: torch.Tensor) -> torch.Tensor:
    """:func:`gf_matrix_to_bits_torch` of one (r, k) matrix as float32 on
    ``M``'s device, built 64 columns of M at a time straight into the
    result: column c of M fills rows c·16 … c·16+15, so the temporaries are
    those of a (r, 64) slice, not of the whole matrix (a (2730, 1366)
    parity matrix has a 3.8 GB float32 bit matrix, and its whole-matrix
    int32 temporaries would be four times that)."""
    r, k = M.shape
    out = torch.empty((k * 16, r * 16), dtype=torch.float32, device=M.device)
    for c0 in range(0, k, 64):
        c1 = min(k, c0 + 64)
        out[c0 * 16: c1 * 16] = gf_matrix_to_bits_torch(M[:, c0:c1])
    return out


def parity_bits_packed(M: torch.Tensor) -> torch.Tensor:
    """:func:`gf256.pack_matrix` of :func:`gf_matrix_to_bits_torch` of one
    (r, k) matrix, built on ``M``'s device 64 columns of M at a time
    straight into its int32 words: (r·16, packed_words(16·k)).  Column c of
    M is bits 16·(c % 2) … of word c // 2 of rows j·16 + b, so a chunk of 64
    columns fills 32 words, and its temporaries are those of a (r, 64, 16)
    slice (a (10922, 5462) parity matrix packs into 1.9 GB; its float32 bit
    matrix would be 61 GB)."""
    r, k = M.shape
    words = gf256.packed_words(16 * k)
    out = torch.zeros((r, 16, words), dtype=torch.int32, device=M.device)
    shifts = _tables(M.device)[2]
    for c0 in range(0, k, 64):
        c1 = min(k, c0 + 64)
        prod = gf_mul_torch(M[:, c0:c1, None], 1 << shifts)  # (r, c, i): M[j, c]·x^i
        # half[j, c, b] = Σ_i (bit b of prod[j, c, i]) << i
        half = torch.zeros((r, c1 - c0, 16), dtype=torch.int64, device=M.device)
        for i in range(16):
            half |= ((prod[:, :, i, None] >> shifts) & 1).long() << i
        if (c1 - c0) % 2:
            half = torch.nn.functional.pad(half, (0, 0, 0, 1))
        word = half[:, 0::2] | (half[:, 1::2] << 16)  # (r, c/2, b), below 2^32
        word = (word ^ 0x80000000) - 0x80000000  # the int32 with those bits
        out[:, :, c0 // 2: c0 // 2 + word.shape[1]] = word.to(torch.int32).transpose(1, 2)
    return out.reshape(r * 16, words)


def pack_shards(x: torch.Tensor, words: int) -> torch.Tensor:
    """uint8 (..., k, B) shards, B even → packed int32 (..., B//2, words):
    row t holds the symbols at byte pair t of shards 0 … k−1, symbol c in
    bits 16c … 16c+15 (:func:`gf_matrix_to_bits`'s input numbering)."""
    *lead, k, B = x.shape
    if x.stride(-1) != 1 or x.storage_offset() % 2 or any(
            st % 2 for st in x.stride()[:-1]):
        x = x.clone(memory_format=torch.contiguous_format)
    sym = x.view(torch.int16)  # (..., k, B/2): little-endian byte pairs
    out = torch.zeros((*lead, B // 2, 2 * words), dtype=torch.int16, device=x.device)
    out[..., :k] = sym.transpose(-1, -2)
    return out.view(torch.int32)


def unpack_shards(out: torch.Tensor, r: int) -> torch.Tensor:
    """The packed product's bytes uint8 (..., B//2, 2r) → r shards uint8
    (..., r, B)."""
    sym = out.view(torch.int16).transpose(-1, -2)  # (..., r, B/2)
    res = torch.empty(sym.shape, dtype=torch.int16, device=sym.device)
    return res.copy_(sym).view(torch.uint8)


def gf_apply_packed(data: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Apply a packed GF(2^16) bit matrix (:func:`parity_bits_packed`, or
    ``gf256.pack_matrix`` of :func:`gf_matrix_to_bits`; int32 (..., r*16,
    W)) to shard bytes uint8 (..., k, B): uint8 (..., r, B)."""
    r = packed.shape[-2] // 16
    return unpack_shards(gf256.bitplane_packed(pack_shards(data, packed.shape[-1]), packed), r)


def gf_apply_bitmatrix(data: torch.Tensor, bitmat: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2^16) matrix to shard bytes.

    data: uint8 (..., k, B) with even B; bitmat (k*16, r*16) from
    :func:`gf_matrix_to_bits`, or batched (..., k*16, r*16) from
    :func:`gf_matrix_to_bits_torch`.  Returns uint8 (..., r, B), through
    :func:`gf256.bitplane_packed`."""
    return gf_apply_packed(data, gf256.pack_matrix(bitmat.to(data.device)))
