"""A lane model of the tensor-core bit-plane kernel (``csrc/bitplane.cu``):
its launch plan, the TMA boxes and their swizzle in shared memory, the
``wgmma m64n128k256 .b1 .and.popc`` operands read through their
descriptors, the accumulators lane by lane, the ring of stages, and the
epilogue's shuffles and stores, in numpy, held against the plain packed
product (``gf256.bitplane_packed_plain``) at the paths' shapes cut to a few
tiles: ragged rows, 176 and 336 columns, a matrix a batch entry, and the
three GF(2^16) chunks' contraction lengths.

The model reads the kernel's tile constants from the source and follows its
index arithmetic step for step, so a layout mistake shows here as a wrong
bit before it shows on the card.  What it takes from the PTX ISA: TMA's
32/64/128-byte swizzle (address bits 4… XOR bits 7…), the K-major
descriptor's rows of the swizzle's width in 8-row atoms, and the
accumulator layout (thread 32w + 4g + t holds D[16w + g (+ 8)][8j + 2t (+
1)] in d[4j … 4j + 3]); ``chip_smoke.py``'s ``kernel_bitplane`` checks the
kernel built on them bit-exact on the card."""

import os
import re

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.ops import gf256

SRC = os.path.join(os.path.dirname(gf256.__file__), "..", "csrc", "bitplane.cu")


def _constants() -> dict:
    with open(SRC) as fh:
        text = fh.read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


K = _constants()
ROWS, COLS, STEP, ALIGN = K["kRows"], K["kCols"], K["kStep"], K["kAlign"]
THREADS = K["kThreads"]


def plan(batch, rows, words, cols, sms, blocks_per_sm):
    """make_plan, with the card's SMs and blocks an SM given."""
    ksteps = words // 8
    resident = ksteps <= K["kMaxBox"] and cols <= K["kResidentCols"]
    box = (1 if ksteps <= 1 else 2 if ksteps <= 2 else 4) if resident else K["kMaxBox"]
    stages = 1 if resident else -(-ksteps // K["kMaxBox"])
    ring = K["kResidentRing"] if resident else K["kStreamRing"]
    col_chunks = -(-cols // COLS) if resident else 1
    col_tiles = -(-cols // (col_chunks * COLS))
    row_tiles = -(-rows // ROWS)
    if resident:
        chunks = max(1, min(row_tiles, sms * blocks_per_sm // (batch * col_tiles)))
    else:
        chunks = row_tiles
    return dict(resident=resident, box=box, stages=stages, ring=ring, col_chunks=col_chunks,
                col_tiles=col_tiles, row_tiles=row_tiles, chunks=chunks)


def layout(q):
    """The kernel's Layout: offsets from the aligned base."""
    box_bytes = q["box"] * STEP
    a_bytes, b_chunk = ROWS * box_bytes, COLS * box_bytes
    slot = a_bytes + (0 if q["resident"] else b_chunk)
    b_res = q["col_chunks"] * b_chunk if q["resident"] else 0
    ring_off = ALIGN + b_res
    out_off = ring_off + q["ring"] * slot
    out_stride = q["col_chunks"] * (COLS // 8) + 4
    return dict(box_bytes=box_bytes, a_bytes=a_bytes, b_chunk=b_chunk, slot=slot,
                ring_off=ring_off, out_off=out_off, out_stride=out_stride,
                out_bytes=ROWS * out_stride, bytes=out_off + 2 * ROWS * out_stride)


def swizzle(o, sw):
    """TMA's (and wgmma's) swizzle of byte offset ``o`` from a 1024-byte
    aligned base, for rows of ``sw`` bytes: bits 4… XOR bits 7…"""
    return o ^ (((o >> 7) & (sw // 16 - 1)) << 4)


def tma_load(smem, dst, tensor, x, y, box_bytes, box_rows):
    """One box (rows y …, bytes x …) of a 2-D byte tensor into ``dst`` with
    the swizzle of ``box_bytes``; outside the tensor reads as zero."""
    n, width = tensor.shape
    r = np.arange(box_rows)[:, None]
    b = np.arange(box_bytes)[None, :]
    inside = (y + r < n) & (x + b < width)
    vals = np.where(inside, tensor[np.minimum(y + r, n - 1), np.minimum(x + b, width - 1)], 0)
    smem[dst + swizzle(r * box_bytes + b, box_bytes)] = vals


def operand(smem, base, kk, n_rows, sw):
    """A k256 step of a K-major operand as the descriptor names it: rows of
    ``sw`` bytes from ``base`` (1024-aligned), step kk's 32 bytes a row, as
    (n_rows, 8) words."""
    r = np.arange(n_rows)[:, None]
    b = np.arange(STEP)[None, :]
    return np.ascontiguousarray(smem[base + swizzle(r * sw + kk * STEP + b, sw)]).view(np.uint32)


def wgmma_b1(d, a_words, b_words, accumulate):
    """d[thread, 4j + e] = popc(A & B) (+ d when ``accumulate``) at the
    accumulator layout."""
    if not accumulate:
        d[:] = 0
    D = np.bitwise_count(a_words[:, None, :] & b_words[None, :, :]).sum(-1).astype(np.int64)
    T = np.arange(THREADS)
    w, g, t = T >> 5, (T & 31) >> 2, T & 3
    for j in range(COLS // 8):
        d[:, 4 * j] += D[16 * w + g, 8 * j + 2 * t]
        d[:, 4 * j + 1] += D[16 * w + g, 8 * j + 2 * t + 1]
        d[:, 4 * j + 2] += D[16 * w + g + 8, 8 * j + 2 * t]
        d[:, 4 * j + 3] += D[16 * w + g + 8, 8 * j + 2 * t + 1]


def run_block(p, q, A2, M2, out, bx, by):
    """One block of bitplane_wgmma (copies land at once)."""
    L = layout(q)
    rows, words, cols = p["rows"], p["words"], p["cols"]
    ksteps, R = words // 8, q["ring"]
    batch, chunk = bx // q["chunks"], bx % q["chunks"]
    tile0 = chunk * q["row_tiles"] // q["chunks"]
    tile1 = (chunk + 1) * q["row_tiles"] // q["chunks"]
    col0 = by * q["col_chunks"] * COLS
    col_valid = min(q["col_chunks"] * COLS, cols - col0)
    a_row0 = batch * rows
    m_row0 = (batch * cols if p["per_batch"] else 0) + col0
    orb = cols // 8
    o_base = batch * rows * orb + col0 // 8
    n_items = (tile1 - tile0) * q["stages"]
    # stale shared memory: the kernel never clears it
    smem = np.random.default_rng(bx * 7 + by).integers(0, 256, L["bytes"], dtype=np.uint8)

    def issue(it):
        tt, s = divmod(it, q["stages"])
        slot = L["ring_off"] + (it % R) * L["slot"]
        tma_load(smem, slot, A2, s * L["box_bytes"], a_row0 + (tile0 + tt) * ROWS,
                 L["box_bytes"], ROWS)
        if not q["resident"]:
            tma_load(smem, slot + L["a_bytes"], M2, s * L["box_bytes"], m_row0,
                     L["box_bytes"], COLS)

    if q["resident"]:
        for c in range(q["col_chunks"]):
            tma_load(smem, ALIGN + c * L["b_chunk"], M2, 0, m_row0 + c * COLS,
                     L["box_bytes"], COLS)
    for it in range(min(R, n_items)):
        issue(it)

    T = np.arange(THREADS)
    warp, lane = T >> 5, T & 31
    g, t = lane >> 2, lane & 3
    d = np.zeros((THREADS, 64), np.int64)
    for it in range(n_items):
        tt, s = divmod(it, q["stages"])
        row0 = (tile0 + tt) * ROWS
        rows_here = min(ROWS, rows - row0)
        slot = L["ring_off"] + (it % R) * L["slot"]
        kn = min(q["box"], ksteps - s * q["box"])
        stage_out = L["out_off"] + (tt & 1) * L["out_bytes"]
        for c in range(q["col_chunks"]):
            bp = ALIGN + c * L["b_chunk"] if q["resident"] else slot + L["a_bytes"]
            for kk in range(kn):
                wgmma_b1(d, operand(smem, slot, kk, ROWS, L["box_bytes"]),
                         operand(smem, bp, kk, COLS, L["box_bytes"]), s > 0 or kk > 0)
            if s != q["stages"] - 1:
                continue
            lo, hi = np.zeros((4, THREADS), np.uint64), np.zeros((4, THREADS), np.uint64)
            words_here = (col_valid - c * COLS + 31) >> 5
            for qq in range(min(4, words_here)):
                for jj in range(4):
                    j, sh = 4 * qq + jj, (8 * jj + 2 * t).astype(np.uint64)
                    lo[qq] |= ((d[:, 4 * j] & 1).astype(np.uint64) << sh) | (
                        (d[:, 4 * j + 1] & 1).astype(np.uint64) << (sh + 1))
                    hi[qq] |= ((d[:, 4 * j + 2] & 1).astype(np.uint64) << sh) | (
                        (d[:, 4 * j + 3] & 1).astype(np.uint64) << (sh + 1))
                for x in (lo, hi):  # __shfl_xor_sync by 1, then by 2, within each warp
                    x[qq] |= x[qq][T ^ 1]
                    x[qq] |= x[qq][T ^ 2]
            off = c * (COLS // 8) + 4 * t
            for word, row in ((lo[t, T], 16 * warp + g), (hi[t, T], 16 * warp + g + 8)):
                addr = stage_out + row * L["out_stride"] + off
                smem[addr[:, None] + np.arange(4)] = (
                    word.astype(np.uint32)[:, None].view(np.uint8).reshape(THREADS, 4))
        if it + R < n_items:
            issue(it + R)
        if s != q["stages"] - 1:
            continue
        # thread x copies unit x % per_row of rows x // per_row, + step, …
        u = 4 if orb % 4 == 0 else 2 if orb % 2 == 0 else 1
        per_row = (col_valid >> 3) // u
        step = THREADS // per_row
        x = np.arange(step * per_row)
        r0, qu = x // per_row, (x % per_row) * u
        r = (r0[:, None] + step * np.arange(-(-ROWS // step))[None, :]).reshape(-1)
        qu = np.repeat(qu, -(-ROWS // step))
        keep = r < rows_here
        r, qu = r[keep], qu[keep]
        assert len(r) == rows_here * per_row
        src = stage_out + r * L["out_stride"] + qu
        dst = o_base + (row0 + r) * orb + qu
        assert (dst % u == 0).all()
        out[dst[:, None] + np.arange(u)] = smem[src[:, None] + np.arange(u)]


def model_bitplane(a, m, sms, blocks_per_sm):
    """The kernel's output for packed int32 ``a`` (batch, rows, W) and ``m``
    (cols, W) or (batch, cols, W), as the wrapper launches it; and its plan."""
    nb, R, W = a.shape
    cols = m.shape[-2]
    if m.ndim == 2:  # a shared matrix: every entry's rows are rows of one product
        batch, rows, per_batch = 1, nb * R, False
    else:
        batch, rows, per_batch = nb, R, True
    A2 = np.ascontiguousarray(a).view(np.uint8).reshape(batch * rows, 4 * W)
    M2 = np.ascontiguousarray(m).view(np.uint8).reshape(-1, 4 * W)
    p = dict(rows=rows, words=W, cols=cols, per_batch=per_batch)
    q = plan(batch, rows, W, cols, sms, blocks_per_sm)
    out = np.full(nb * R * cols // 8, 0xA5, np.uint8)
    for bx in range(q["chunks"] * batch):
        for by in range(q["col_tiles"]):
            run_block(p, q, A2, M2, out, bx, by)
    return out.reshape(nb, R, cols // 8), q


def _operands(rng, batch, rows, d, cols, per_batch):
    """Packed random operands of ``d`` real bits, zero-padded as the
    packers pad them."""
    bits = rng.integers(0, 2, (batch, rows, d), dtype=np.int8)
    mshape = (batch, d, cols) if per_batch else (d, cols)
    mat = rng.integers(0, 2, mshape, dtype=np.int8)
    return gf256.pack_bits(torch.from_numpy(bits)), gf256.pack_matrix(torch.from_numpy(mat))


# the paths' shapes cut to a few tiles: (batch, rows, bits, cols, a matrix
# an entry, the card's SMs and blocks an SM for the plan)
CASES = {
    # N = 64 encode: 176 bits, 336 columns (three 128-column chunks, the
    # last 80 wide); 4 entries of 53 rows folded into 212 rows, 2 ranges
    "n64_encode": (4, 53, 176, 336, False, 2, 1),
    # the masked decode: a 176 x 176 matrix an entry, ragged rows
    "masked_decode": (3, 100, 176, 176, True, 2, 2),
    # the GF(2^16) chunks: streamed, ragged stages and column tiles
    "n1024_chunk": (1, 100, 5472, 200, False, 132, 2),
    "n4096_chunk": (1, 64, 21856, 136, False, 132, 2),
    "n16384_chunk": (1, 64, 87392, 40, False, 132, 2),
    # small runtime products: 4 and 8 data shards (N = 10, 22)
    "n10_runtime": (1, 7, 32, 48, False, 132, 4),
    "n22_decode": (2, 5, 64, 64, True, 132, 4),
    # three k256 steps (a 128-byte box past the row), a 64-byte box
    "k3_resident": (2, 70, 700, 96, True, 3, 1),
    "k2_resident": (1, 130, 400, 264, False, 1, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_model_equals_plain_product(name):
    batch, rows, d, cols, per_batch, sms, bps = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    a, m = _operands(rng, batch, rows, d, cols, per_batch)
    got, q = model_bitplane(a.numpy(), m.numpy(), sms, bps)
    want = gf256.bitplane_packed_plain(a, m).numpy()
    assert np.array_equal(got, want), name
    assert q["resident"] == (a.shape[-1] // 8 <= K["kMaxBox"] and cols <= K["kResidentCols"])


def test_plan_fits_the_paths_shapes():
    """The N = 64 shapes take the resident route in one block's columns and
    one wave; the GF(2^16) chunks stream; the N = 4096 chunk spreads over
    the card; every plan's shared memory fits a block."""
    sms, limit = 132, 227 * 1024
    enc = plan(1, 187136, 8, 336, sms, 4)
    assert enc["resident"] and enc["col_chunks"] == 3 and enc["col_tiles"] == 1
    assert enc["chunks"] == 4 * sms
    dec = plan(1408, 2924, 8, 176, sms, 4)
    assert dec["resident"] and dec["col_chunks"] == 2 and dec["chunks"] == 1
    for rows, words, cols in ((6080, 176, 10912), (64, 688, 43680), (64, 2736, 174752)):
        q = plan(1, rows, words, cols, sms, 2)
        assert not q["resident"] and q["col_chunks"] == 1
        assert layout(q)["bytes"] + ALIGN <= limit // 2  # two blocks an SM
    n4096 = plan(1, 64, 688, 43680, sms, 2)
    assert n4096["col_tiles"] * n4096["chunks"] >= 2 * sms
    widest = plan(1, 64, 32, K["kResidentCols"], sms, 1)
    assert widest["resident"] and layout(widest)["bytes"] + ALIGN <= limit
