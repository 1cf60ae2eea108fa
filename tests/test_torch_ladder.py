"""The whole-ladder kernel's design against the reference, on the CPU.

``csrc/fp_lazy.cuh`` and ``csrc/ladder_lazy.cu`` run only on the card.  Here
a lane model of their warp schedule — lanes as the first tensor axis, a
shuffle as a gather along it, one column per warp — follows the device
functions step for step and is held digit-exact against the plain field
(``fp_lazy.mul_lazy_cols``, ``fp381``'s lazy add/sub), against one G1 and
one G2 step of the plain ladder, and over a short whole ladder against the
CPU side of ``gcurve.scalar_mul_lazy``.  The model computes in int64 and
checks that every sum the kernel holds in int32 stays below 2^31.  Then
edge scalars through the split ladders against the JAX package's curve,
and the port's linear KDF against the JAX package's."""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu.crypto import tc as jtc
from hbbft_tpu_torch.crypto import batch as tb
from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.ops import fp381 as F
from hbbft_tpu_torch.ops import fp_lazy
from hbbft_tpu_torch.ops import gcurve as G
from hbbft_tpu_torch.ops import ladder_lazy

NL, BITS, MASK = F.NL, F.LIMB_BITS, F.MASK
L = torch.arange(32)[:, None]  # lane index, broadcast over the warps
INT32_LIMIT = 1 << 31

# shared-memory constants of fp_lazy.cuh: one column per lane, 0 on 30 and 31
S_FOLD = torch.zeros((NL + 1, 32, 1), dtype=torch.int64)
S_FOLD[:, :NL, 0] = torch.from_numpy(F._FOLD_HI.astype(np.int64))
S_SUBC = torch.zeros((32, 1), dtype=torch.int64)
S_SUBC[:NL, 0] = torch.from_numpy(F._SUBC_LIMBS.astype(np.int64))


def shfl(x, src):
    """__shfl_sync: every lane reads lane ``src`` (an int or a lane tensor)."""
    if isinstance(src, int):
        return x[src].expand_as(x)
    return torch.gather(x, 0, src.expand_as(x))


def shfl_up(x):
    """__shfl_up_sync(…, 1): lane l reads lane l − 1; lane 0 keeps its own."""
    return torch.cat([x[:1], x[:-1]])


def i32(x):
    assert int(x.abs().max()) < INT32_LIMIT, "an int32 sum of the kernel would wrap"
    return x


def carry31(x):
    for _ in range(3):
        c = shfl_up(x >> BITS)
        x = (x & MASK) + torch.where(L == 0, 0, c)
        x = torch.where(L == 31, 0, x)
    return x


def squeeze(x):
    x = carry31(i32(x))
    for _ in range(4):
        top = shfl(x, NL)
        x = i32(torch.where(L < NL, x + top * S_FOLD[0], 0))
        x = carry31(x)
    return torch.where(L < NL, x, 0)


def mul(a, b):
    lo = torch.zeros_like(a)
    hi = torch.zeros_like(a)
    for i in range(NL):
        ai = shfl(a, i)
        src = torch.where(L >= i, L - i, L - i + 31)
        p = ai * shfl(b, src)
        lo = torch.where(i <= L, lo + p, lo)
        hi = torch.where(i <= L, hi, hi + p)
    lo = i32(torch.where(L == 31, 0, lo))
    hi = i32(hi)
    for _ in range(3):
        clo, chi = lo >> BITS, hi >> BITS
        up_lo, up_hi, c30 = shfl_up(clo), shfl_up(chi), shfl(clo, NL)
        lo = (lo & MASK) + torch.where(L == 0, 0, up_lo)
        hi = (hi & MASK) + torch.where(L == 0, c30, up_hi)
        lo = torch.where(L == 31, 0, lo)
        hi = torch.where(L >= NL, 0, hi)
    acc = torch.where(L < NL, lo, 0) + shfl(lo, NL) * S_FOLD[0]
    for j in range(1, NL + 1):
        acc = acc + shfl(hi, j - 1) * S_FOLD[j]
    return squeeze(acc)


def add(a, b):
    return squeeze(a + b)


def sub(a, b):
    return squeeze(torch.where(L < NL, a + (2 * MASK - b) + S_SUBC, 0))


class LaneFp:
    """The device functions over lane tensors, as a gcurve field bundle."""

    add = staticmethod(add)
    sub = staticmethod(sub)
    mul = staticmethod(mul)
    sqr = staticmethod(lambda a: mul(a, a))


class LaneFp2:
    """fp_lazy.cuh's Fp2 ((re, im) pairs of lane tensors)."""

    @staticmethod
    def add(a, b):
        return add(a[0], b[0]), add(a[1], b[1])

    @staticmethod
    def sub(a, b):
        return sub(a[0], b[0]), sub(a[1], b[1])

    @staticmethod
    def mul(a, b):
        sa, sb = add(a[0], a[1]), add(b[0], b[1])
        t0, t1, t2 = mul(a[0], b[0]), mul(a[1], b[1]), mul(sa, sb)
        return sub(t0, t1), sub(t2, add(t0, t1))

    @staticmethod
    def sqr(a):
        t0 = mul(add(a[0], a[1]), sub(a[0], a[1]))
        t1 = mul(a[0], a[1])
        return t0, add(t1, t1)


def to_lanes(cols):
    """(NL, R) digit columns → (32, R) int64 lanes, 0 on lanes 30 and 31."""
    return torch.cat([cols.long(), torch.zeros((2, cols.shape[1]), dtype=torch.int64)])


def from_lanes(x):
    assert not x[NL:].any(), "lanes 30 and 31 must hold 0 between operations"
    return x[:NL].to(torch.int32)


def lane_step(o, acc, inf, base, base_inf, bit):
    """ladder_lazy.cu's loop body over per-row flags (R,)."""
    def sel(m, p, q):  # a warp-uniform select, coordinate by coordinate
        return tuple(
            tuple(torch.where(m, u, v) for u, v in zip(pc, qc)) if isinstance(pc, tuple)
            else torch.where(m, pc, qc)
            for pc, qc in zip(p, q)
        )

    d = G.point_double(o, acc)
    s = G.point_add_raw(o, d, base)
    res = sel(inf, base, sel(base_inf, d, s))
    return sel(bit, res, d), torch.where(bit, inf & base_inf, inf)


def _digits(rng, shape, extreme_cols=1):
    """Lazy-invariant digits in [0, 2^13]; the first columns all 2^13."""
    d = rng.integers(0, (1 << BITS) + 1, shape).astype(np.int32)
    d[:, :extreme_cols] = 1 << BITS
    return torch.from_numpy(d)


def test_lane_model_mul_add_sub_digit_exact():
    rng = np.random.default_rng(61)
    a, b = _digits(rng, (NL, 48)), _digits(rng, (NL, 48))
    a[:, 1] = 0
    fold = F.consts("cpu").fold
    la, lb = to_lanes(a), to_lanes(b)
    assert torch.equal(from_lanes(mul(la, lb)), fp_lazy.mul_lazy_cols(a, b, fold))
    assert torch.equal(from_lanes(mul(la, la)), fp_lazy.mul_lazy_cols(a, a, fold))
    assert torch.equal(from_lanes(add(la, lb)), F.fp_add_lazy(a, b))
    assert torch.equal(from_lanes(sub(la, lb)), F.fp_sub_lazy(a, b))
    assert torch.equal(from_lanes(sub(torch.zeros_like(la), la)), F.fp_neg_lazy(a))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_ladder_step_matches_plain_step(group):
    """One step (double, raw add, the three selects, inf) at 4 rows, with
    every (bit, inf, base_inf) combination that changes the result."""
    rng = np.random.default_rng(62 if group == "g1" else 63)
    R = 4
    fp2 = group == "g2"
    width = 2 * R if fp2 else R
    acc = tuple(_digits(rng, (NL, width)) for _ in range(3))
    base = tuple(_digits(rng, (NL, width)) for _ in range(3))
    inf = torch.tensor([False, True, False, False])
    base_inf = torch.tensor([False, False, True, False])
    bit = torch.tensor([True, True, True, False])

    ops = G.LAZY_FP2_OPS if fp2 else G.LAZY_FP_OPS
    ref, ref_inf = G.ladder_step(ops, acc, inf, base, base_inf, bit)

    if fp2:
        def lanes(c):
            return to_lanes(c[:, :R]), to_lanes(c[:, R:])

        def cols(x):
            return torch.cat([from_lanes(x[0]), from_lanes(x[1])], dim=1)
        o = LaneFp2
    else:
        lanes, cols, o = to_lanes, from_lanes, LaneFp
    got, got_inf = lane_step(
        o, tuple(lanes(c) for c in acc), inf, tuple(lanes(c) for c in base), base_inf, bit
    )
    assert torch.equal(got_inf, ref_inf)
    for g, r in zip(got, ref):
        assert torch.equal(cols(g), r)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_cpu_dispatch_is_the_plain_ladder(group):
    """``scalar_mul_lazy`` on CPU tensors against the lane model of the
    kernel's whole loop (acc = 0 with inf set, then ``lane_step`` MSB
    first): a zero scalar, a base_inf row and two finite rows, 6 bits."""
    rng = random.Random(64)
    fp2 = group == "g2"
    if fp2:
        pts = [jc.g2_mul(jc.G2_GEN, rng.randrange(1, jc.R)) for _ in range(3)] + [None]
        pt, ops = G.g2_to_device(pts, "cpu"), G.LAZY_FP2_OPS
    else:
        pts = [jc.g1_mul(jc.G1_GEN, rng.randrange(1, jc.R)) for _ in range(3)] + [None]
        pt, ops = G.g1_to_device(pts, "cpu"), G.LAZY_FP_OPS
    bits = torch.tensor([[0, 0, 0, 0, 0, 0], [1, 0, 1, 1, 0, 1],
                         [0, 1, 1, 0, 1, 1], [1, 1, 0, 1, 0, 0]], dtype=torch.int32)
    base_inf = torch.tensor([p is None for p in pts])
    got, got_inf = G.scalar_mul_lazy(ops, pt, bits, base_inf)
    assert got_inf.tolist() == [True, False, False, True]

    R = len(pts)
    if fp2:
        def lanes(c):
            return to_lanes(c[:, :R]), to_lanes(c[:, R:])

        def cols(x):
            return torch.cat([from_lanes(x[0]), from_lanes(x[1])], dim=1)
        o = LaneFp2
    else:
        lanes, cols, o = to_lanes, from_lanes, LaneFp
    base = tuple(lanes(c) for c in pt)
    acc = tuple(lanes(torch.zeros_like(c)) for c in pt)
    inf = torch.ones(R, dtype=torch.bool)
    for i in reversed(range(bits.shape[1])):
        acc, inf = lane_step(o, acc, inf, base, base_inf, bits[:, i].bool())
    assert torch.equal(inf, got_inf)
    for g, r in zip(acc, got):
        assert torch.equal(cols(g), r)


def test_ladder_kernel_wrapper_takes_only_cuda_tensors():
    pts = G.g1_to_device([None], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ladder_lazy.ladder_lazy(pts, torch.zeros((1, 4), dtype=torch.int32),
                                torch.ones(1, dtype=torch.bool), fp2=False)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_edge_scalars_match_host(group):
    """0, r − 1 and 1 on finite bases, and a nonzero scalar on a None base,
    through the GLV/GLS-split ladders against the JAX package's curve."""
    rng = random.Random(65 if group == "g1" else 66)
    sc = [0, jc.R - 1, 1, rng.randrange(1, jc.R)]
    if group == "g1":
        pts = [jc.g1_mul(jc.G1_GEN, rng.randrange(1, jc.R)) for _ in range(3)] + [None]
        got = tb.cache_for("cpu").g1_mul_batch(pts, sc)
        for g, p, s in zip(got, pts, sc):
            assert jc.g1_eq(g, jc.g1_mul(p, s))
    else:
        pts = [jc.g2_mul(jc.G2_GEN, rng.randrange(1, jc.R)) for _ in range(3)] + [None]
        got = tb.cache_for("cpu").g2_mul_batch(pts, sc)
        for g, p, s in zip(got, pts, sc):
            assert jc.g2_eq(g, jc.g2_mul(p, s))
    assert got[0] is None and got[3] is None


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 64000])
def test_kdf_stream_matches_jax(length):
    seed = bytes(range(97))
    assert tc._kdf_stream(seed, length) == jtc._kdf_stream(seed, length)
    data = bytes((7 * i + 3) % 256 for i in range(length))
    stream = jtc._kdf_stream(seed, length)
    assert tc._xor_mask(data, seed) == bytes(a ^ b for a, b in zip(data, stream))
