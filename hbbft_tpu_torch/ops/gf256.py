"""GF(2^8) arithmetic — host tables and the bit-plane lowering in PyTorch.

Field: GF(2^8) with reducing polynomial x^8+x^4+x^3+x^2+1 (0x11D) and
generator 2, the ``reed-solomon-erasure`` crate's field (counterpart of
``hbbft_tpu/ops/gf256.py``).

1. **Host (numpy)** — log/exp tables, matrix construction and inversion,
   and the cached bitmatrix-XOR schedule (the host coder's ``numpy``
   backend, :func:`build_xor_schedule` / :func:`apply_xor_schedule`).
2. **Device (torch)** — multiplication by a constant GF(2^8) matrix is
   linear over GF(2), so it lowers to ONE 0/1 matrix product with the
   parity taken (``& 1``): the 8×-expanded bit matrix against the data's
   bits.  Both operands are packed 32 bits a word along the contraction
   axis, and a shard row of GF(2^8) symbols packed so is its bytes as they
   are.  :func:`bitplane_packed` is that product for this field and for
   GF(2^16) (``ops/gf16.py``): on a CUDA tensor the hand-written kernel
   ``csrc/bitplane.cu``, on a CPU tensor its plain version
   :func:`bitplane_packed_plain` (a float32 product of the unpacked bits).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hbbft_tpu_torch import _build

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
GF_GEN = 2

# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()

_A = np.arange(256)
_MUL_TABLE = np.zeros((256, 256), dtype=np.uint8)
_nz = _A[1:]
_MUL_TABLE[1:, 1:] = GF_EXP[(GF_LOG[_nz][:, None] + GF_LOG[_nz][None, :]) % 255]


def gf_mul(a, b):
    """Elementwise GF(2^8) multiply (numpy, any broadcastable uint8 shapes)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return _MUL_TABLE[a, b]


def gf_inv(a):
    a = np.asarray(a)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return GF_EXP[255 - GF_LOG[a]]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_matmul_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product (host). A: (r,k), B: (k,c) → (r,c)."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    r, k = A.shape
    assert k == B.shape[0]
    out = np.zeros((r, B.shape[1]), dtype=np.uint8)
    for i in range(k):
        out ^= _MUL_TABLE[A[:, i][:, None], B[i][None, :]]
    return out


def gf_inv_matrix_np(M: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss–Jordan elimination (host)."""
    M = np.asarray(M, dtype=np.uint8)
    n = M.shape[0]
    assert M.shape == (n, n)
    aug = np.concatenate([M.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul(aug[col], gf_inv(aug[col, col]))
        mask = aug[:, col].copy()
        mask[col] = 0
        aug ^= _MUL_TABLE[mask[:, None], aug[col][None, :]]
    return aug[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[r, c] = r^c in GF(2^8) — the ``reed-solomon-erasure`` construction."""
    V = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            V[r, c] = gf_pow(r, c)
    return V


def gf_matrix_to_bits(M: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix (r, k) to its GF(2) bit matrix (k*8, r*8).

    ``A[k*8 + i, j*8 + b]`` = bit ``b`` of ``gf_mul(M[j, k], 1 << i)``, so
    for data bits ``D`` (..., k*8), ``(D @ A) & 1`` gives output bit b of
    symbol j at ``[..., j*8 + b]``.
    """
    M = np.asarray(M, dtype=np.uint8)
    r, k = M.shape
    powers = np.left_shift(1, np.arange(8)).astype(np.uint8)
    prod = _MUL_TABLE[M[:, :, None], powers[None, None, :]]
    bits = (prod[..., None] >> np.arange(8)) & 1
    return bits.transpose(1, 2, 0, 3).reshape(k * 8, r * 8).astype(np.int8)


# ---------------------------------------------------------------------------
# Cached bitmatrix-XOR schedule (host hot path)
# ---------------------------------------------------------------------------
#
# "Accelerating XOR-based Erasure Coding using Program Optimization
# Techniques" playbook: a constant GF(2^8) matrix is a GF(2) bitmatrix, so
# applying it is pure XORs of bit-planes.  The schedule is computed ONCE per
# matrix (the per-call cost of the old table-matmul path was the whole
# problem), common XOR subexpressions are eliminated greedily, and execution
# walks the shards in column tiles so every plane of a tile stays cache-hot.


class XorSchedule:
    """A straight-line XOR program for one constant bit matrix.

    Nodes ``0..n_in-1`` are the input bit-planes (input symbol ``k``, bit
    ``i`` → node ``k*8 + i``).  Each op ``(dest, a, b)`` defines node
    ``dest = a ^ b`` (the CSE intermediates, in dependency order).
    ``outputs[j]`` lists the node ids whose XOR is output bit-row ``j``
    (output symbol ``j // 8``, bit ``j % 8``).
    """

    __slots__ = ("n_in", "ops", "outputs", "xor_count")

    def __init__(self, n_in, ops, outputs):
        self.n_in = n_in
        self.ops = ops
        self.outputs = outputs
        self.xor_count = len(ops) + sum(
            max(0, len(o) - 1) for o in outputs
        )


def build_xor_schedule(bitmat: np.ndarray) -> XorSchedule:
    """Compile a (k*8, r*8) bit matrix into an :class:`XorSchedule`.

    Greedy pairwise common-subexpression elimination: repeatedly extract
    the operand pair shared by the most output rows into an intermediate
    node.  Fully deterministic (ties break on the smallest pair), so the
    schedule — and therefore the XOR order — is a pure function of the
    matrix.

    The reference recounts every pair of every output row for each
    extraction (minutes at 64 shards).  Here the pair counts are kept up to
    date as rows change, and the best pair comes off a heap whose entries
    may overstate a count (counts only fall after a pair's first
    extraction step): an entry found stale is pushed back with its current
    count, so the first entry popped at its true count is the largest
    count with the smallest pair, the reference's choice at every step.
    """
    import heapq
    from itertools import combinations

    bitmat = np.asarray(bitmat)
    n_in, n_out = bitmat.shape
    sets = [
        set(int(i) for i in np.nonzero(bitmat[:, j])[0])
        for j in range(n_out)
    ]
    members: dict = {}  # node → output rows holding it
    counts: dict = {}  # (x, y), x < y → rows holding both
    for j, s in enumerate(sets):
        for x in s:
            members.setdefault(x, set()).add(j)
        for pair in combinations(sorted(s), 2):
            counts[pair] = counts.get(pair, 0) + 1
    heap = [(-c, x, y) for (x, y), c in counts.items() if c >= 2]
    heapq.heapify(heap)

    ops = []
    next_id = n_in
    while heap:
        neg, a, b = heapq.heappop(heap)
        c = counts.get((a, b), 0)
        if c != -neg:
            if c >= 2:
                heapq.heappush(heap, (-c, a, b))
            continue
        d = next_id
        ops.append((d, a, b))
        rows = members[a] & members[b]
        fresh: dict = {}  # x → rows where d joins x
        for j in rows:
            s = sets[j]
            s.discard(a)
            s.discard(b)
            for x in s:
                for y in (a, b):
                    pair = (y, x) if y < x else (x, y)
                    left = counts[pair] - 1
                    if left:
                        counts[pair] = left
                    else:
                        del counts[pair]
                fresh[x] = fresh.get(x, 0) + 1
            s.add(d)
        del counts[(a, b)]
        for x, n in fresh.items():
            counts[(x, d)] = n
            if n >= 2:
                heapq.heappush(heap, (-n, x, d))
        members[a] -= rows
        members[b] -= rows
        members[d] = set(rows)
        next_id += 1
    return XorSchedule(n_in, ops, [sorted(s) for s in sets])


_BIT_WEIGHTS = np.left_shift(1, np.arange(8)).astype(np.uint8)


def apply_xor_schedule(
    sched: XorSchedule,
    data: np.ndarray,
    out: np.ndarray = None,
    tile_bytes: int = 1 << 15,
) -> np.ndarray:
    """Run a schedule over shard rows: (k, B) uint8 → (r, B) uint8.

    ``out`` may be a view into the caller's allocation (the parity tail of
    one contiguous buffer).  Columns are processed ``tile_bytes`` at a time
    so the k+r+intermediate bit-planes of a tile fit in cache.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    k, B = data.shape
    assert k * 8 == sched.n_in
    r8 = len(sched.outputs)
    r = r8 // 8
    if out is None:
        out = np.empty((r, B), dtype=np.uint8)
    n_nodes = sched.n_in + len(sched.ops)
    for t0 in range(0, B, tile_bytes):
        tile = data[:, t0:t0 + tile_bytes]
        T = tile.shape[1]
        # decompose: (k, 8, T) bit arrays → packed planes (k*8, ceil(T/8))
        bits = (
            tile[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]
        ) & 1
        planes = np.packbits(bits != 0, axis=-1, bitorder="little")
        planes = planes.reshape(k * 8, -1)
        nodes: list = [None] * n_nodes
        for i in range(k * 8):
            nodes[i] = planes[i]
        for dest, a, b in sched.ops:
            nodes[dest] = nodes[a] ^ nodes[b]
        W = planes.shape[1]
        obits = np.zeros((r8, W), dtype=np.uint8)
        for j, ids in enumerate(sched.outputs):
            if not ids:
                continue
            acc = nodes[ids[0]]
            for nid in ids[1:]:
                acc = acc ^ nodes[nid]
            obits[j] = acc
        # repack: unpack each output plane and recombine the 8 bit rows
        ob = np.unpackbits(
            obits.reshape(r, 8, W), axis=-1, bitorder="little"
        )[..., :T]
        out[:, t0:t0 + T] = (
            ob * _BIT_WEIGHTS[None, :, None]
        ).sum(axis=1, dtype=np.uint8)
    return out


# ---------------------------------------------------------------------------
# Device path (torch)
# ---------------------------------------------------------------------------

_DEV_TABLES: dict = {}


def _tables(device):
    """(exp int64 (512,), log int64 (256,), shifts int32 (8,)) on ``device``."""
    hit = _DEV_TABLES.get(device)
    if hit is None:
        hit = _DEV_TABLES[device] = (
            torch.from_numpy(GF_EXP.astype(np.int64)).to(device),
            torch.from_numpy(GF_LOG.astype(np.int64)).to(device),
            torch.arange(8, dtype=torch.int32, device=device),
        )
    return hit


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., K) → int8 bits (..., K*8), LSB-first."""
    shifts = _tables(x.device)[2]
    bits = (x.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8).to(torch.int8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """int (..., K*8) bits → uint8 (..., K), LSB-first."""
    shifts = _tables(bits.device)[2]
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.int32)
    return (b << shifts).sum(dim=-1).to(torch.uint8)


# Packed bit planes: bit d of a row is bit d % 32 of int32 word d // 32,
# and a packed row is padded with zero words to a multiple of PACK_WORDS,
# the kernel's contraction step.  A packed matrix holds one row per OUTPUT
# column (the transpose of the reference's (d, m) bit matrix), so a
# column's contraction words are contiguous.
PACK_WORDS = 8


def packed_words(d: int) -> int:
    """Words of a packed row of ``d`` bits, padding included."""
    return -(-d // (32 * PACK_WORDS)) * PACK_WORDS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (..., d) → packed int32 (..., packed_words(d))."""
    d = bits.shape[-1]
    words = packed_words(d)
    x = torch.zeros((*bits.shape[:-1], 32 * words), dtype=torch.uint8, device=bits.device)
    x[..., :d] = bits
    x = x.reshape(*bits.shape[:-1], 4 * words, 8)
    byte = x[..., 0].clone()
    for s in range(1, 8):
        byte |= x[..., s] << s
    return byte.view(torch.int32)


def unpack_bits(words: torch.Tensor, d: int) -> torch.Tensor:
    """Packed int32 (..., W) → int8 bits (..., d), d ≤ 32·W."""
    return bytes_to_bits(words.contiguous().view(torch.uint8))[..., :d]


def pack_matrix(bitmat: torch.Tensor) -> torch.Tensor:
    """A 0/1 bit matrix (..., d, m) in the reference's layout → the packed
    matrix int32 (..., m, packed_words(d)): row c holds column c's bits."""
    return pack_bits(bitmat.transpose(-1, -2))


def unpack_matrix(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Packed int32 (..., m, W) → the int8 bit matrix (..., d, m)."""
    return unpack_bits(packed, d).transpose(-1, -2)


def pack_bytes(x: torch.Tensor, words: int) -> torch.Tensor:
    """GF(2^8) symbol rows, uint8 (..., B, k) with k ≤ 4·words → packed
    int32 (..., B, words): symbol c's bits are bits 8c … 8c+7, so a row's
    bytes, zero-padded, are its packed words as they stand."""
    out = torch.zeros((*x.shape[:-1], 4 * words), dtype=torch.uint8, device=x.device)
    out[..., : x.shape[-1]] = x
    return out.view(torch.int32)


def bitplane_parity_plain(bits: torch.Tensor, bitmat: torch.Tensor) -> torch.Tensor:
    """``(bits @ bitmat) & 1`` for 0/1 operands, exactly: int32 (..., m).

    bits: (..., d) 0/1; bitmat: (d, m) or batched (..., d, m) 0/1 on
    ``bits``'s device.  One float32 ``torch.matmul``, and that is exact:
    each product is 0 or 1, and every partial sum is an integer of at most
    ``d`` < 2^24, which float32 holds without rounding.  TF32 would be exact
    as well (0 and 1 survive its 10-bit mantissa, and it accumulates in
    float32), so the result does not depend on
    ``torch.backends.cuda.matmul.allow_tf32``, and this function leaves that
    process-wide setting alone."""
    depth = bits.shape[-1]
    if depth >= 1 << 24:
        raise ValueError(f"a bit-plane sum of {depth} terms is not exact in float32")
    prod = torch.matmul(bits.to(torch.float32), bitmat.to(torch.float32))
    return prod.to(torch.int32) & 1


def bitplane_packed_plain(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`bitplane_packed`: both operands unpacked
    to 0/1, :func:`bitplane_parity_plain`, the output packed."""
    d = 32 * a.shape[-1]
    out = bitplane_parity_plain(unpack_bits(a, d), unpack_matrix(m, d))
    return bits_to_bytes(out)


def bitplane_packed(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The GF(2) product over packed bits: uint8 (..., R, cols / 8) whose
    bit c of row t is ``parity(popcount(a[..., t, :] & m[..., c, :]))``.

    a: packed data int32 (..., R, W); m: packed matrix int32 (cols, W), or
    batched (..., cols, W) broadcast-compatible with ``a``; W a multiple of
    ``PACK_WORDS``, cols of 8.  A CUDA tensor goes through the hand-written
    kernel (``csrc/bitplane.cu``) or raises, a CPU tensor through
    :func:`bitplane_packed_plain`."""
    if a.dtype != torch.int32 or m.dtype != torch.int32:
        raise TypeError(f"bitplane_packed takes int32 words, got {a.dtype}, {m.dtype}")
    R, W = a.shape[-2:]
    cols = m.shape[-2]
    if m.shape[-1] != W or W % PACK_WORDS or cols % 8:
        raise ValueError(f"bitplane_packed: data {tuple(a.shape)}, matrix {tuple(m.shape)}: "
                         f"want equal word counts, a multiple of {PACK_WORDS}, and "
                         "output columns a multiple of 8")
    if not a.is_cuda:
        return bitplane_packed_plain(a, m)
    if m.device != a.device:
        raise ValueError(f"bitplane_packed: data on {a.device}, matrix on {m.device}")
    if m.dim() == 2 and a.is_contiguous() and m.is_contiguous():
        # the common call, a shared matrix: no views to make
        batch, a3, m3 = a.shape[:-2], a, m
    else:
        batch = torch.broadcast_shapes(a.shape[:-2], m.shape[:-2])
        a3 = a.expand(*batch, R, W).contiguous()
        m3 = m if m.shape[:-2].numel() == 1 else m.expand(*batch, cols, W)
        m3 = m3.contiguous()
    nb = batch.numel()
    if m3.shape[:-2].numel() == 1:
        # one shared matrix: every batch entry's rows are rows of one product
        m_stride, launch_batch, launch_rows = 0, 1, nb * R
    else:
        m_stride, launch_batch, launch_rows = cols * W, nb, R
    out = torch.empty((*batch, R, cols // 8), dtype=torch.uint8, device=a.device)
    if nb and R and cols:
        # TMA row coordinates and the grid are 32-bit
        if nb * R >= 1 << 31 or (nb if m_stride else 1) * cols >= 1 << 31:
            raise ValueError(f"bitplane_packed: {nb} x {R} rows, {cols} columns exceed the grid")
        if a3.data_ptr() % 16 or m3.data_ptr() % 16:
            raise ValueError("bitplane_packed: operands not 16-byte aligned")
        rc = _build.lib("bitplane").hb_bitplane(
            a3.data_ptr(), m3.data_ptr(), out.data_ptr(), launch_batch, launch_rows, W, cols,
            m_stride, _build.stream_ptr(a3))
        _build.check("bitplane", rc)
        _build.count("bitplane")
    return out


_PLAN_KEYS = ("resident", "box_steps", "stages", "ring", "row_chunks", "col_tiles",
              "col_chunks", "blocks_per_sm", "sms", "smem_bytes", "blocks")


def _bitplane_fn(name: str, argtypes):
    fn = getattr(_build.lib("bitplane"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def bitplane_plan(batch: int, rows: int, words: int, cols: int) -> dict:
    """The launch :func:`bitplane_packed` makes on the current CUDA device
    for ``batch`` products of ``rows`` rows (a shared matrix: one product of
    every entry's rows), ``words`` words and ``cols`` columns: the route
    (``resident`` 1: the matrix stays in shared memory; 0: it streams), k256
    steps a TMA box, stages a row tile, ring slots, row-tile ranges an
    entry, column tiles, 128-column chunks a block, blocks an SM, SMs,
    dynamic shared bytes, blocks."""
    out = (ctypes.c_int64 * len(_PLAN_KEYS))()
    rc = _bitplane_fn("hb_bitplane_plan", [ctypes.c_int] * 4 + [ctypes.c_void_p])(
        batch, rows, words, cols, ctypes.addressof(out))
    _build.check("bitplane", rc)
    return dict(zip(_PLAN_KEYS, out))


def bitplane_probe(kind: int, blocks: int, iters: int, out: torch.Tensor) -> None:
    """Launch ``csrc/bitplane.cu``'s rate probe (on no path): ``blocks``
    blocks of 256 threads, each running ``iters`` rounds of independent
    1-bit products, ``kind`` 0 ``mma.sync`` m16n8k256 (64 a warp a round),
    1 ``wgmma`` m64n128k256 (16 a warpgroup a round); ``out`` is CUDA int32
    of ``256 * blocks`` words."""
    if not out.is_cuda or out.dtype != torch.int32 or out.numel() < 256 * blocks:
        raise ValueError("bitplane_probe: out must be CUDA int32 of 256 words a block")
    rc = _bitplane_fn("hb_bitplane_probe", [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)(
        kind, blocks, iters, out.data_ptr(), _build.stream_ptr(out))
    _build.check("bitplane", rc)


def gf_apply_packed(data: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Apply a packed GF(2^8) bit matrix (``pack_matrix`` of
    :func:`gf_matrix_to_bits`, int32 (..., r*8, W)) to byte data uint8
    (..., B, k): uint8 (..., B, r)."""
    return bitplane_packed(pack_bytes(data, packed.shape[-1]), packed)


def gf_apply_bitmatrix(data: torch.Tensor, bitmat: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2^8) matrix to byte data.

    data: uint8 (..., B, k); bitmat: (k*8, r*8) from
    :func:`gf_matrix_to_bits`, or batched (..., k*8, r*8) from
    :func:`gf_matrix_to_bits_torch` broadcast-compatible with ``data``.
    Returns uint8 (..., B, r), through :func:`bitplane_packed`.
    """
    return gf_apply_packed(data, pack_matrix(bitmat.to(data.device)))


def gf_mul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^8) multiply of two runtime uint8 tensors via
    log/exp gathers (counterpart of ``gf_mul_jnp``)."""
    exp, log, _ = _tables(a.device)
    r = exp[(log[a.long()] + log[b.long()]) % 255]
    return torch.where((a != 0) & (b != 0), r, 0).to(torch.uint8)


def gf_inv_torch(a: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^8) inverse; maps 0 → 0 (caller masks)."""
    exp, log, _ = _tables(a.device)
    r = exp[255 - log[a.long()]]
    return torch.where(a != 0, r, 0).to(torch.uint8)


def gf_inv_matrix_impl(M: torch.Tensor, mul, inv, dtype) -> tuple:
    """Field-generic batched Gauss–Jordan (char-2: elimination is XOR).

    Pivots on the FIRST nonzero entry at or below the diagonal, like the
    host :func:`gf_inv_matrix_np` and the JAX reference, so decode matrices
    are bit-identical.  Returns ``(inv, ok)``; ``ok`` is False for singular
    inputs, whose ``inv`` is garbage."""
    M = M.to(dtype)
    n = M.shape[-1]
    batch = M.shape[:-2]
    dev = M.device
    eye = torch.eye(n, dtype=dtype, device=dev).expand(*batch, n, n)
    aug = torch.cat([M, eye], dim=-1)  # (..., n, 2n)
    rows = torch.arange(n, device=dev)
    idx = rows.expand(*batch, n)
    ok = torch.ones(batch, dtype=torch.bool, device=dev)
    for col in range(n):
        cand = (aug[..., :, col] != 0) & (rows >= col)
        ok = ok & cand.any(dim=-1)
        # argmax returns the first maximal index: the first True
        piv = torch.argmax(cand.to(torch.int32), dim=-1)[..., None]
        perm = torch.where(idx == col, piv, torch.where(idx == piv, col, idx))
        aug = torch.gather(aug, -2, perm[..., None].expand(*batch, n, 2 * n))
        pivot_row = mul(aug[..., col, :], inv(aug[..., col, col])[..., None])
        aug[..., col, :] = pivot_row
        factors = aug[..., :, col] * (rows != col).to(dtype)
        aug = aug ^ mul(factors[..., None], pivot_row[..., None, :])
    return aug[..., n:], ok


def gf_inv_matrix_torch(M: torch.Tensor) -> tuple:
    """Batched GF(2^8) matrix inversion: uint8 (..., n, n) → (inv, ok)."""
    return gf_inv_matrix_impl(M, gf_mul_torch, gf_inv_torch, torch.uint8)


def gf_matrix_to_bits_torch(M: torch.Tensor) -> torch.Tensor:
    """Batched :func:`gf_matrix_to_bits`: uint8 (..., r, k) → int8
    (..., k*8, r*8), same layout as the host function."""
    r, k = M.shape[-2:]
    shifts = _tables(M.device)[2]
    powers = (1 << shifts).to(torch.uint8)
    prod = gf_mul_torch(M[..., None], powers)  # (..., r, k, 8)
    bits = (prod.to(torch.int32)[..., None] >> shifts) & 1  # (..., r, k, i, b)
    A = bits.movedim(-4, -2)  # (..., k, i, r, b)
    return A.reshape(*M.shape[:-2], k * 8, r * 8).to(torch.int8)
