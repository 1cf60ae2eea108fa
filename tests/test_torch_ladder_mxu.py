"""The 8-bit field's windowed ladder kernel, modelled on the CPU.

``csrc/ladder_mxu.cu`` (the field of ``csrc/fp_mxu.cuh`` under the step
machinery of ``csrc/ladder_steps.cuh``) runs only on the card.  Here a lane
model of its field at K elements a warp (K = 1, 2, 4; an element's 32/K
lanes, 2K digits a lane) follows the device functions step for step: the
product of a warp's K elements — each one's convolution as four
``mma.m16n8k16`` products of its Toeplitz block (the instruction modelled
from the PTX fragment layouts, operands checked exact in f16 and sums in
f32), the quad lanes' column sums and their exchange, the rough carry
over 100 positions 4K a lane with the scratch's unwritten words as
garbage, the fold of the K elements' high digits as B's columns against
``ladder_mxu.fold_fragments`` — and the squeeze's four rounds with one
exchange each.  It is held digit-exact against the plain
``fp381_mxu.fp_mul``, ``fp_add``, ``fp_sub``.  The kernel's own step
tables (``ops/ladder_schedule.py``, the 13-bit kernel's) then run over it
through ``test_torch_ladder``'s and ``test_torch_ladder_window``'s walkers:
one dbl and one addp table against ``point_double``/``point_add_raw`` over
``MXU_FP_OPS``/``MXU_FP2_OPS``, the whole windowed kernel against
``scalar_mul_lazy_window_plain`` and, at 8 bits, against the reference's
``scalar_mul_lazy_window`` over ``hbbft_tpu/ops/fp381_mxu.py``.  Also:
the fragments decode to the fold matrix, ``scalar_mul_lazy_window`` picks
the kernel by its ops table's field and raises on a table with no kernel,
the constants are cached once a device, and the launchers take CUDA
tensors only."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ladder as lanes_mod
import test_torch_ladder_window as window_mod
from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu.ops import fp381_mxu as JM
from hbbft_tpu.ops import gcurve as jg
from hbbft_tpu_torch.crypto.bls12_381 import P
from hbbft_tpu_torch.ops import fp381_mxu as M
from hbbft_tpu_torch.ops import gcurve as G
from hbbft_tpu_torch.ops import ladder_lazy, ladder_mxu

NL = M.NL
ROW = 64  # an element's row of words
KS = (1, 2, 4)  # field elements a warp
LANES = np.arange(32)
GRP, TIG = LANES // 4, LANES % 4  # an mma lane's group and its thread in the group
F32_EXACT = 1 << 24
INT32_LIMIT = 1 << 31


def _halves(reg):
    reg = np.asarray(reg, dtype=np.uint32)
    lo = (reg & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float64)
    hi = (reg >> 16).astype(np.uint16).view(np.float16).astype(np.float64)
    return lo, hi


def _pair_t(v):
    """f16 pair registers of digits (``pack_h2``: exact for 0 ≤ n < 1024)
    as their values."""
    assert v.min() >= 0 and v.max() < 1024, "pack_h2 takes digits in [0, 1024)"
    return v.astype(np.float64)


def _i32(x):
    assert np.abs(x).max() < INT32_LIMIT, "an int32 sum of the kernel would wrap"
    return x


def _a_matrix(a):
    """m16n8k16's A from the lanes' registers (..., 32, 4, 2): register j
    of lane (g, t) holds row g + 8(j & 1), columns 2t + 8(j >> 1) and the
    next."""
    A = np.zeros(a.shape[:-3] + (16, 16))
    for j in range(4):
        r, c = GRP + 8 * (j & 1), 2 * TIG + 8 * (j >> 1)
        A[..., r, c] = a[..., j, 0]
        A[..., r, c + 1] = a[..., j, 1]
    return A


def _b_matrix(b):
    """B (16 × 8) from (..., 32, 2, 2): register j of lane (g, t) holds rows
    2t + 8j and the next of column g."""
    B = np.zeros(b.shape[:-3] + (16, 8))
    for j in range(2):
        B[..., 2 * TIG + 8 * j, GRP] = b[..., j, 0]
        B[..., 2 * TIG + 8 * j + 1, GRP] = b[..., j, 1]
    return B


def _d_regs(D):
    """The lanes' f32 sums (..., 32, 4) of D (..., 16, 8): rows g, g + 8 of
    columns 2t, 2t + 1.  The operands are non-negative, so every partial
    sum the instruction accumulates is at most its total."""
    assert np.abs(D).max() < F32_EXACT, "an f32 sum of the kernel would round"
    return np.stack([D[..., GRP, 2 * TIG], D[..., GRP, 2 * TIG + 1],
                     D[..., GRP + 8, 2 * TIG], D[..., GRP + 8, 2 * TIG + 1]], axis=-1)


def _passes(x):
    """Three rough passes along axis 1 of x (a copy), whose first three
    positions are the window below (not computed: pass 1 from position 1,
    pass 2 from 2, pass 3 from 3); each pass reads the one before it, as
    the descending loop of the kernel does."""
    x = x.copy()
    for p in (1, 2, 3):
        x[:, p:] = (x[:, p:] & M.MASK) + (x[:, p - 1:-1] >> M.DIGIT_BITS)
    return x


class MxuLanes:
    """fp_mxu.cuh's Field<K> on slot rows (64, R): R elements, a warp's K
    side by side (R padded to a multiple of K with zero rows, as a block's
    rows past the batch).  Lane layout: element e's G = 32/K lanes as the
    first axis, a lane's D = 2K digits the second (position D·j + m).  The
    model computes in numpy int64 and float64 and checks the kernel's int32,
    f16 and f32 ranges."""

    def __init__(self, K):
        self.K, self.G, self.D, self.span = K, 32 // K, 2 * K, 4 * K
        lo, hi = _halves(ladder_mxu.fold_fragments())  # (mt, ks, lane, reg)
        self.fold_a = _a_matrix(np.stack([lo, hi], axis=-1))  # (mt, ks, 16, 16)
        self.keep = np.arange(ROW) < NL
        subc = np.zeros(ROW, dtype=np.int64)
        subc[:NL] = M._SUBC_LIMBS
        self.subk = np.where(self.keep, 2 * M.MASK + subc, 0)
        # the squeeze rows at words 4 + p of 68 (zeros outside 0 … 48)
        self.sq = np.zeros((3, 68), dtype=np.int64)
        self.sq[:, 4:4 + NL] = M._SQUEEZE_ROWS
        self.j = np.arange(self.G)[:, None]  # (G, 1)
        self.garbage = np.random.default_rng(91)

    # -- layout --
    def lanes(self, row):
        return row.reshape(self.G, self.D, -1)

    def row(self, v):
        return v.reshape(ROW, -1)

    # -- the squeeze --
    def window_below(self, v):
        """(G, 3, R): positions D·j − 3, − 2, − 1 of the lanes below in the
        group (0 below position 0)."""
        flat = v.reshape(ROW, -1)  # position D·j + m
        at = self.D * self.j - 3 + np.arange(3)  # (G, 3)
        return np.where((at >= 0)[..., None], flat[np.maximum(at, 0)], 0)

    def squeeze(self, v):
        """fp_mxu.cuh's squeeze on (G, D, R): four rounds of passes over the
        window; between two, positions 49 … 51 (broadcast) and the next
        window (the digits below after this round's passes) folded."""
        D = self.D
        _i32(v)
        span = D * self.j - 3 + np.arange(D + 3)  # (G, D + 3): the window's positions, the lane's
        sq = self.sq[:, 4 + span][..., None]  # (3, G, D + 3, 1), 0 outside 0 … 48
        keep = (span < NL)[..., None]
        x = np.concatenate([self.window_below(v), v], axis=1)
        for rnd in range(4):
            x = _passes(x)
            if rnd == 3:
                break
            # the window's digits are the lower lanes' after these passes
            x = np.concatenate([self.window_below(x[:, 3:]), x[:, 3:]], axis=1)
            t = x[:, 3:].reshape(ROW, -1)[NL:NL + 3]  # (3, R): one lane's or two, broadcast
            x = _i32(np.where(keep, x, 0) + (t[:, None, None, :] * sq).sum(0))
        return np.where(keep[:, 3:], x[:, 3:], 0)

    # -- the product --
    def _conv(self, a, b):
        """Stage 1: each element's convolution into the scratch rows T
        (128, R); positions 112 … 127, never written, hold garbage."""
        R = a.shape[1]
        # pair i (0 … 8) of a lane: (a_y, a_{y−1}) at y = qg − 2qt + 8(i − 1)
        y = (GRP - 2 * TIG)[:, None, None] + 8 * (np.arange(9)[:, None] - 1) - np.arange(2)
        pr = _pair_t(np.where((y >= 0)[..., None], a[np.clip(y, 0, ROW - 1)], 0))  # (32, 9, 2, R)
        # tile mt's A: pairs 2mt + 1, 2mt + 2, 2mt, 2mt + 1
        pick = np.array([[2 * mt + 1, 2 * mt + 2, 2 * mt, 2 * mt + 1] for mt in range(4)])
        areg = pr[:, pick].transpose(4, 1, 0, 2, 3)  # (R, mt, 32, 4, 2)
        # B column q = qg < 4: digits 16q + 2qt (+1), + 8 (+9) of b
        jb = (16 * np.minimum(GRP, 3) + 2 * TIG)[:, None, None] + np.array([[0, 1], [8, 9]])
        breg = _pair_t(np.where((GRP < 4)[:, None, None, None], b[jb], 0))  # (32, 2, 2, R)
        d = _d_regs(_a_matrix(areg) @ _b_matrix(breg.transpose(3, 0, 1, 2))[:, None])
        # position 8i + qg, i = 2u + h: quad lane 0 sums columns 0, 1 (tiles
        # u, u − 1), lane 1 columns 2, 3 (tiles u − 2, u − 3)
        dp = np.pad(d, ((0, 0), (3, 3), (0, 0), (0, 0)))  # tile m at m + 3
        u = np.arange(7)
        s = np.stack([np.where(TIG == 0, dp[:, u + 3][..., 2 * h] + dp[:, u + 2][..., 2 * h + 1],
                               dp[:, u + 1][..., 2 * h] + dp[:, u][..., 2 * h + 1])
                      for h in (0, 1)], axis=2)  # (R, u, h, 32)
        even, odd = s[:, :, 0], s[:, :, 1]  # i = 2u, 2u + 1: lane 0 keeps the even, lane 1 the odd
        mine = np.where(TIG == 1, odd, even)
        send = np.where(TIG == 1, even, odd)
        val = np.rint(mine + send[..., LANES ^ 1]).astype(np.int64)  # (R, 7, 32)
        own = TIG < 2
        pos = 8 * (2 * u[:, None] + TIG[own]) + GRP[own]  # (7, 16)
        T = self.garbage.integers(0, INT32_LIMIT, (128, R))
        T[pos.reshape(-1)] = val[..., own].reshape(R, -1).T
        return T

    def _carry(self, T):
        """Stage 2: three passes over 100 positions, 4K a lane of its
        element's lanes (the window from the scratch), 0 from 100."""
        X = T.reshape(self.G, self.span, -1)
        below = np.concatenate([np.zeros_like(X[:1, :3]), X[:-1, -3:]])
        out = _passes(np.concatenate([below, X], axis=1))[:, 3:].reshape(128, -1)
        out[100:] = 0
        return out

    def _fold(self, T):
        """Stage 3: per warp, the fold matrix (A) against its K elements'
        high digits (B's columns 0 … K − 1), 16 mma; the fold's digits F
        (64, R)."""
        K, R = self.K, T.shape[1]
        W = R // K
        Tw = T.reshape(128, W, K)
        # B: k-step ks, register j of lane (qg, qt): positions NL + 16ks +
        # 2qt + 8j (+1) of element qg < K
        k = NL + 16 * np.arange(4)[:, None, None, None] + 2 * TIG[:, None, None] \
            + np.array([[0, 1], [8, 9]])  # (ks, 32, 2, 2)
        h = _pair_t(Tw[k, :, np.minimum(GRP, K - 1)[:, None, None]])  # (ks, 32, 2, 2, W)
        h = np.where((GRP < K)[:, None, None, None], h, 0).transpose(4, 0, 1, 2, 3)
        # mt's sums over the 4 k-steps, one mma each
        D = np.einsum("mkij,wkjn->wmin", self.fold_a, _b_matrix(h))
        fo = _d_regs(D)  # (W, mt, 32, 4)
        F = np.zeros((ROW, W, K), dtype=np.int64)
        for c in (0, 1):
            n = 2 * TIG + c
            sel = n < K
            for half in (0, 1):
                rows = 16 * np.arange(4)[:, None] + GRP[sel] + 8 * half  # (mt, lanes)
                F[rows, :, n[sel]] = np.rint(fo[:, :, sel, 2 * half + c]).transpose(1, 2, 0)
        return F.reshape(ROW, R)

    def mul_unsqueezed(self, a, b):
        assert not a[NL:].any() and not b[NL:].any()
        T = self._carry(self._conv(a, b))
        F = self._fold(T)
        return self.lanes(_i32(np.where(self.keep[:, None], T[:ROW] + F, 0)))

    # -- the operations, on slot rows (64, R) of int64 --
    def mul(self, a, b):
        R = a.shape[1]
        pad = ((0, 0), (0, -R % self.K))
        x, y = (np.pad(t.numpy(), pad) for t in (a, b))
        return torch.from_numpy(self.row(self.squeeze(self.mul_unsqueezed(x, y)))[:, :R].copy())

    def add(self, a, b):
        return torch.from_numpy(self.row(self.squeeze(self.lanes((a + b).numpy()))).copy())

    def sub(self, a, b):
        x = (a - b).numpy() + self.subk[:, None]
        return torch.from_numpy(self.row(self.squeeze(self.lanes(x))).copy())


MXU_LANES = {K: MxuLanes(K) for K in KS}


def _cols(rows):
    return torch.from_numpy(np.ascontiguousarray(rows.T))


def _rows(cols):
    return lanes_mod.to_lanes(cols, ROW)


def test_fold_fragments_decode_to_the_fold_matrix():
    frag = ladder_mxu.fold_fragments()
    want = ladder_mxu.fold_matrix()
    got = np.zeros_like(want)
    for mt in range(4):
        for ks in range(4):
            for j in range(4):
                lo, hi = _halves(frag[mt, ks, :, j])
                r = 16 * mt + GRP + 8 * (j & 1)
                col = 16 * ks + 2 * TIG + 8 * (j >> 1)
                got[r, col], got[r, col + 1] = lo, hi
    assert np.array_equal(got, want)
    assert np.array_equal(want[:NL, :M._N_HI], JM._FOLD_ROWS.T)


def test_fmul_lane_model_digit_exact():
    """The product of a warp's K elements, several in the fold's B
    columns (K = 1, 2, 4): the edges (all digits 0, 255, 256, 383, p − 1)
    against each other and random lazy digits, against the plain product;
    and the sum and the difference."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 257, size=(14, NL)).astype(np.int32)
    rows[:5] = [np.zeros(NL), np.full(NL, 255), np.full(NL, 256), np.full(NL, 383),
                M.int_to_limbs(P - 1)]
    a, b = _cols(rows), _cols(rows[::-1])
    want = {"mul": M.fp_mul(a, b), "sqr": M.fp_mul(a, a), "add": M.fp_add(a, b),
            "sub": M.fp_sub(a, b)}
    for K in KS:
        lanes = MXU_LANES[K]
        got = {"mul": lanes.mul(_rows(a), _rows(b)), "sqr": lanes.mul(_rows(a), _rows(a)),
               "add": lanes.add(_rows(a), _rows(b)), "sub": lanes.sub(_rows(a), _rows(b))}
        for name, w in want.items():
            assert torch.equal(lanes_mod.from_lanes(got[name], NL), w), (K, name)


def _digits(rng, shape):
    """Lazy-invariant digits in [0, 256], the first column all 256."""
    d = rng.integers(0, 257, shape).astype(np.int32)
    d[:, 0] = 256
    return torch.from_numpy(d)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("kind", ["dbl", "addp"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_window_tables_match_plain(group, kind, K):
    """The 13-bit kernel's dbl and addp tables over the 8-bit field's lane
    model at 3 rows, K elements a warp: digit-exact with ``point_double`` /
    ``point_add_raw`` over ``MXU_FP_OPS`` / ``MXU_FP2_OPS``."""
    rng = np.random.default_rng(92 if group == "g1" else 93)
    R = 3
    width = 2 * R if group == "g2" else R
    acc = tuple(_digits(rng, (NL, width)) for _ in range(3))
    base = tuple(_digits(rng, (NL, width)) for _ in range(3))
    ops = G.MXU_FP2_OPS if group == "g2" else G.MXU_FP_OPS
    ref = G.point_double(ops, acc) if kind == "dbl" else G.point_add_raw(ops, acc, base)
    got = lanes_mod.lane_table(group, kind, MXU_LANES[K], acc, base, ROW, NL)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _points(group, rng, n):
    if group == "g1":
        return [jc.g1_mul(jc.G1_GEN, rng.randrange(1, jc.R)) for _ in range(n)]
    return [jc.g2_mul(jc.G2_GEN, rng.randrange(1, jc.R)) for _ in range(n)]


def _mxu_window(group, pts, scalars, nbits, K):
    """(the plain ladder's and the lane-model kernel's results, the
    device-layout inputs)"""
    pt = (G.g2_to_device if group == "g2" else G.g1_to_device)(pts, "cpu", rep=M)
    ops = G.MXU_FP2_OPS if group == "g2" else G.MXU_FP_OPS
    bits = torch.from_numpy(G.scalars_to_bits(scalars, nbits=nbits))
    base_inf = torch.tensor([p is None for p in pts])
    ref = G.scalar_mul_lazy_window_plain(ops, pt, bits, base_inf)
    got = window_mod.lane_window(group, pt, bits, base_inf, K, MXU_LANES[K], ROW, NL)
    return ref, got, (pt, bits, base_inf)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_window_kernel_matches_plain(group, K):
    """The whole windowed kernel (the table by dbl and addp steps, then
    per window dblpro, dbl, dbl and the bitwise step on each row's own
    entry) over the 8-bit field's lane model at K elements a warp: 8 bits
    (two windows, zero windows included) at 4 rows, a None base among
    them, digit- and inf-exact with the plain ladder, garbage digits of the
    ∞ row too."""
    rng = random.Random(94 if group == "g1" else 95)
    pts = _points(group, rng, 3) + [None]
    (ref, ref_inf), (got, got_inf), _ = _mxu_window(group, pts, [0x5A, 0x07, 0xF0, 0x31], 8, K)
    assert torch.equal(got_inf, ref_inf)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _fori(lo, hi, body, init):
    v = init
    for i in range(lo, hi):
        v = body(i, v)
    return v


def test_lane_model_window_kernel_digit_exact_with_reference(monkeypatch):
    """G2 at K = 2 over 8 bits and 4 rows, a None base and a zero scalar
    among them: the lane model of the kernel against the reference's
    ``scalar_mul_lazy_window(MXU_FP2_OPS, …)`` (each field op jitted on its
    own, its ``fori_loop`` run as the Python loop it stands for), every
    digit and every inf flag."""
    monkeypatch.setattr(jax.lax, "fori_loop", _fori)
    rng = random.Random(96)
    pts = _points("g2", rng, 3)
    pts.insert(1, None)
    scalars = [0xC3, 0x5E, 0, 0x81]
    _, (got, got_inf), (_, bits, base_inf) = _mxu_window("g2", pts, scalars, 8, 2)

    class JitOps:
        pass

    ref_ops = JitOps()
    for op in ("add", "sub", "mul", "sqr", "neg", "is_zero", "select"):
        setattr(ref_ops, op, jax.jit(getattr(jg.MXU_FP2_OPS, op)))
    jpt = tuple(tuple(jnp.asarray(x) for x in co) for co in jg.g2_to_device(pts, rep=JM))
    ref, ref_inf = jg.scalar_mul_lazy_window(ref_ops, jpt, jnp.asarray(bits.numpy()),
                                             jnp.asarray(base_inf.numpy()))
    assert got_inf.tolist() == np.asarray(ref_inf).tolist() == [False, True, True, False]
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), np.concatenate([np.asarray(r[0]), np.asarray(r[1])]).T)


def test_consts_cached_once_a_device(monkeypatch):
    """Two spellings of one device share one entry of the constants' cache
    (``"cuda"``, ``torch.device("cuda", 0)`` and ``"cuda:0"`` with device 0
    current; ``"cpu"`` and ``torch.device("cpu")``)."""
    made = []

    class Stub:
        def __init__(self, device):
            made.append(device)

    monkeypatch.setattr(ladder_mxu, "_CONSTS", {})
    monkeypatch.setattr(ladder_mxu, "_Consts", Stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda = {id(ladder_mxu._consts(d)) for d in ("cuda", torch.device("cuda", 0), "cuda:0",
                                                 torch.device("cuda"))}
    cpu = {id(ladder_mxu._consts(d)) for d in ("cpu", torch.device("cpu"))}
    assert len(cuda) == len(cpu) == 1
    assert made == [torch.device("cuda", 0), torch.device("cpu")]


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
    with pytest.raises(ValueError, match="CUDA"):
        ladder_mxu.ladder_mxu_k(pt, torch.zeros((1, 4), dtype=torch.int32),
                                torch.ones(1, dtype=torch.bool), fp2=False, k=2)
    with pytest.raises(ValueError, match="K is one of"):
        ladder_mxu.ladder_mxu_k(pt, torch.zeros((1, 4), dtype=torch.int32),
                                torch.ones(1, dtype=torch.bool), fp2=False, k=3)
