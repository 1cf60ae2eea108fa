"""The 8-bit field's windowed ladder kernel, modelled on the CPU.

``csrc/ladder_mxu.cu`` runs only on the card.  Here a numpy model of one
warp runs its product (``fmul``) as the kernel does, lane by lane: the
staging row of f16 pairs, the Toeplitz A fragments and the digit B
fragments of ``mma.m16n8k16.row.col`` (the instruction modelled from the
PTX fragment layouts, f16 operands and f32 sums checked exact), the quad
lanes' column sums and their shuffle, the rough carry four digits a lane,
the fold through ``ladder_mxu.fold_fragments``, the squeeze two digits a
lane; it is held digit-exact against the plain ``fp381_mxu.fp_mul``.
Also: the fragments decode to the fold matrix, ``scalar_mul_lazy_window``
picks the kernel by its ops table's field and raises on a table with no
kernel, and the launcher takes CUDA tensors only."""

import numpy as np
import pytest
import torch

from hbbft_tpu.ops import fp381_mxu as JM
from hbbft_tpu_torch.crypto.bls12_381 import P
from hbbft_tpu_torch.ops import fp381_mxu as M
from hbbft_tpu_torch.ops import gcurve as G
from hbbft_tpu_torch.ops import ladder_lazy, ladder_mxu

NL = M.NL
LANES = np.arange(32)
GRP, TIG = LANES // 4, LANES % 4


def _pack(lo, hi):
    """Two integers as the f16 pair of one register (``pack_h2``)."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    assert lo.min() >= 0 and max(lo.max(), hi.max()) <= 2048  # exact in f16

    def bits(v):
        return np.asarray(v, dtype=np.float16).view(np.uint16).astype(np.uint32)

    return bits(lo) | (bits(hi) << 16)


def _halves(reg):
    reg = np.asarray(reg, dtype=np.uint32)
    lo = (reg & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float64)
    hi = (reg >> 16).astype(np.uint16).view(np.float16).astype(np.float64)
    return lo, hi


def _mma(a, b, d):
    """``mma.sync.m16n8k16.row.col.f32.f16.f16.f32``: a (32, 4) and b (32, 2)
    registers of the lanes, d (32, 4) f32 accumulators, by the PTX
    fragment layouts (A: rows g, g + 8, columns 2t, 2t + 1 and + 8; B: rows
    2t, 2t + 1 and + 8 of column g; D: rows g, g + 8 of columns 2t, 2t + 1)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for j in range(4):
        lo, hi = _halves(a[:, j])
        r, col = GRP + 8 * (j & 1), 2 * TIG + 8 * (j >> 1)
        A[r, col], A[r, col + 1] = lo, hi
    for j in range(2):
        lo, hi = _halves(b[:, j])
        B[2 * TIG + 8 * j, GRP], B[2 * TIG + 8 * j + 1, GRP] = lo, hi
    D = A @ B
    out = d + np.stack([D[GRP, 2 * TIG], D[GRP, 2 * TIG + 1],
                        D[GRP + 8, 2 * TIG], D[GRP + 8, 2 * TIG + 1]], axis=1)
    assert np.abs(out).max() < 2 ** 24  # every f32 sum an exact integer
    return out


def _carry_lanes(v):
    """Three rough passes over k digits a lane (v: (32, k)), the carry out
    of lane 31 dropped, the top carry of each lane shuffled up one lane."""
    for _ in range(3):
        c = v >> 8
        v = v & 255
        v[:, 1:] += c[:, :-1]
        v[1:, 0] += c[:-1, -1]
    return v


def _squeeze_lanes(v):
    """``squeeze`` over (32, 2): positions 2·lane, 2·lane + 1."""
    sq = M._SQUEEZE_ROWS
    p = 2 * LANES[:, None] + np.arange(2)
    v = _carry_lanes(v)
    for _ in range(3):
        top = [v[24, 1], v[25, 0], v[25, 1]]
        fold = sum(top[m] * np.where(p < NL, sq[m][np.minimum(p, NL - 1)], 0) for m in range(3))
        v = np.where(p < NL, v + fold, 0)
        v = _carry_lanes(v)
    return np.where(p < NL, v, 0)


def fmul_model(a, b, frag):
    """One warp's ``fmul`` over element rows a, b (64 words: digits 0 … 48,
    zeros after)."""
    pairs = np.zeros(80, dtype=np.uint32)
    for lane in range(32):
        for k in range(3):
            y = lane - 16 + 32 * k
            if k < 2 or lane < 16:
                pairs[y + 16] = _pack(a[y] if y >= 0 else 0, a[y - 1] if y >= 1 else 0)
    j = 16 * GRP + 2 * TIG
    live = GRP < 4
    jj = np.where(live, j, 0)
    breg = np.stack([np.where(live, _pack(b[jj], b[jj + 1]), 0),
                     np.where(live, _pack(b[jj + 8], b[jj + 9]), 0)], axis=1)
    d = []
    for mt in range(4):
        x = 16 * mt + GRP - 2 * TIG + 16
        areg = np.stack([pairs[x], pairs[x + 8], pairs[x - 8], pairs[x]], axis=1)
        d.append(_mma(areg, breg, np.zeros((32, 4))))
    tb = np.zeros(128, dtype=np.int64)
    for u in range(7):
        for h in range(2):
            # quad lane 0 holds columns 0, 1 (tiles u, u − 1), lane 1 columns 2, 3
            s0 = sum(d[u - e][:, 2 * h + e] for e in (0, 1) if 0 <= u - e < 4)
            s1 = sum(d[u - 2 - e][:, 2 * h + e] for e in (0, 1) if 0 <= u - 2 - e < 4)
            s = np.where(TIG == 0, s0, s1) + np.zeros(32)
            s = s + s[LANES ^ 1]
            tb[16 * u + 8 * h + GRP[TIG == 0]] = np.rint(s[TIG == 0])
    v = _carry_lanes(tb.reshape(32, 4).copy())
    tb[:100] = v.reshape(-1)[:100]
    f = [np.zeros((32, 4)) for _ in range(4)]
    for ks in range(4):
        k = M.NL + 16 * ks + 2 * TIG
        first = GRP == 0
        hreg = np.stack([np.where(first, _pack(tb[k], tb[k + 1]), 0),
                         np.where(first, _pack(tb[k + 8], tb[k + 9]), 0)], axis=1)
        for mt in range(4):
            f[mt] = _mma(frag[mt, ks], hreg, f[mt])
    fb = np.zeros(64, dtype=np.int64)
    for mt in range(4):
        fb[16 * mt + GRP[TIG == 0]] = np.rint(f[mt][TIG == 0, 0])
        fb[16 * mt + GRP[TIG == 0] + 8] = np.rint(f[mt][TIG == 0, 2])
    p = np.arange(64)
    acc = np.where(p < NL, tb[:64] + fb, 0)
    return _squeeze_lanes(acc.reshape(32, 2)).reshape(-1)


def test_fold_fragments_decode_to_the_fold_matrix():
    frag = ladder_mxu.fold_fragments()
    want = ladder_mxu.fold_matrix()
    got = np.zeros_like(want)
    for mt in range(4):
        for ks in range(4):
            for j in range(4):
                lo, hi = _halves(frag[mt, ks, :, j])
                r, col = 16 * mt + GRP + 8 * (j & 1), 16 * ks + 2 * TIG + 8 * (j >> 1)
                got[r, col], got[r, col + 1] = lo, hi
    assert np.array_equal(got, want)
    assert np.array_equal(want[:NL, :M._N_HI], JM._FOLD_ROWS.T)


def test_fmul_lane_model_digit_exact():
    """The edges (all digits 0, 255, 256, p − 1) against each other and
    random lazy digits, against the plain product."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 257, size=(12, NL)).astype(np.int32)
    rows[:4] = [np.zeros(NL), np.full(NL, 255), np.full(NL, 256), M.int_to_limbs(P - 1)]
    a_rows, b_rows = rows, rows[::-1]
    want = M.fp_mul(torch.from_numpy(a_rows.T.copy()), torch.from_numpy(b_rows.T.copy())).numpy().T
    frag = ladder_mxu.fold_fragments()
    for a, b, w in zip(a_rows, b_rows, want):
        got = fmul_model(np.pad(a, (0, 64 - NL)).astype(np.int64),
                         np.pad(b, (0, 64 - NL)).astype(np.int64), frag)
        assert np.array_equal(got[:NL], w) and not got[NL:].any()


def test_window_ladder_picks_the_kernel_of_its_field(monkeypatch):
    """On CUDA tensors the lazy tables launch ``ladder_window``, the 8-bit
    tables ``ladder_mxu``, any other table raises; the bitwise ladder has a
    kernel for the lazy tables only."""
    calls = []
    monkeypatch.setattr(ladder_lazy, "ladder_window", lambda *a, fp2: calls.append(("window", fp2)))
    monkeypatch.setattr(ladder_mxu, "ladder_mxu", lambda *a, fp2: calls.append(("mxu", fp2)))

    class _OnCard:
        is_cuda = True

    pt = (_OnCard(), None, None)
    for ops in (G.LAZY_FP_OPS, G.LAZY_FP2_OPS, G.MXU_FP_OPS, G.MXU_FP2_OPS):
        G.scalar_mul_lazy_window(ops, pt, None, None)
    assert calls == [("window", False), ("window", True), ("mxu", False), ("mxu", True)]
    for ops in (G.FP_OPS, G.FP2_OPS):
        with pytest.raises(ValueError, match="no kernel"):
            G.scalar_mul_lazy_window(ops, pt, None, None)
    for ops in (G.MXU_FP_OPS, G.MXU_FP2_OPS, G.FP_OPS):
        with pytest.raises(ValueError, match="no kernel"):
            G.scalar_mul_lazy(ops, pt, None, None)


def test_launcher_takes_cuda_tensors_only():
    pt = G.g1_to_device([None], "cpu", rep=M)
    with pytest.raises(ValueError, match="CUDA"):
        ladder_mxu.ladder_mxu(pt, torch.zeros((1, 4), dtype=torch.int32),
                              torch.ones(1, dtype=torch.bool), fp2=False)
