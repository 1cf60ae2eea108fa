"""The whole-ladder kernel's design against the reference, on the CPU.

``csrc/fp_lazy.cuh`` and ``csrc/ladder_lazy.cu`` run only on the card.  Here
a lane model of them — lanes as the first tensor axis, a shuffle as a
gather along it, a shared-memory row as a lane tensor, one column per row —
follows the device functions step for step: the product's 32 + 32 digit
layout, the windowed carry passes (``carry3`` on a gathered window), the
squeeze's five windowed rounds.  It is held digit-exact against the plain
field (``fp_lazy.mul_lazy_cols``, ``fp381``'s lazy add/sub/neg).  The
ladder step runs from the kernel's own tables
(``ops/ladder_schedule.py``, the source of ``csrc/ladder_schedule.h``):
the prologue, then every warp's operation list with ready flags, warps
interleaved as the flags allow, against one G1 and one G2 step of the plain
ladder and over a short whole ladder against the CPU side of
``gcurve.scalar_mul_lazy``.  The model computes in int64 and checks that
every sum the kernel holds in int32 stays below 2^31.  Then edge scalars
through the split ladders against the JAX package's curve, and the port's
linear KDF against the JAX package's."""

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
from hbbft_tpu_torch.ops import ladder_schedule as S

NL, BITS, MASK = F.NL, F.LIMB_BITS, F.MASK
L = torch.arange(32)[:, None]  # lane index, broadcast over the rows
INT32_LIMIT = 1 << 31

# FieldLane of fp_lazy.cuh: lane l's column of the residue rows and of the
# sub constant, 0 on lanes 30 and 31
FOLD = torch.zeros((NL + 1, 32, 1), dtype=torch.int64)
FOLD[:, :NL, 0] = torch.from_numpy(F._FOLD_HI.astype(np.int64))
SUBC = torch.zeros((32, 1), dtype=torch.int64)
SUBC[:NL, 0] = torch.from_numpy(F._SUBC_LIMBS.astype(np.int64))


def shfl(x, src):
    """__shfl_sync: every lane reads lane ``src`` (an int or a lane tensor)."""
    if isinstance(src, int):
        return x[src].expand_as(x)
    return torch.gather(x, 0, src.expand_as(x))


def lds(row, idx):
    """A shared-memory load: lane l reads ``row[idx[l]]`` (row: (n, R))."""
    return torch.gather(row, 0, idx.expand(32, row.shape[1]))


def shfl_up(x, k):
    """__shfl_up_sync(…, k): lane l reads lane l − k; lanes < k keep their own."""
    return torch.cat([x[:k], x[:-k]])


def i32(x):
    assert int(x.abs().max()) < INT32_LIMIT, "an int32 sum of the kernel would wrap"
    return x


def carry3(x0, x1, x2, x3):
    """Digit p after three rough passes from the digits at p-3 .. p."""
    a1 = i32((x1 & MASK) + (x0 >> BITS))
    b1 = i32((x2 & MASK) + (x1 >> BITS))
    c1 = i32((x3 & MASK) + (x2 >> BITS))
    b2 = i32((b1 & MASK) + (a1 >> BITS))
    c2 = i32((c1 & MASK) + (b1 >> BITS))
    return i32((c2 & MASK) + (b2 >> BITS))


def squeeze(v):
    """Five windowed rounds: each gathers v[l-1..l-3] and v[27..29] once;
    lanes 30 and 31 are masked only at the end."""
    i32(v)
    for rnd in range(5):
        w = [torch.where(L >= k, shfl_up(v, k), 0) for k in (1, 2, 3)]
        t27, t28, t29 = shfl(v, 27), shfl(v, 28), shfl(v, 29)
        y = carry3(w[2], w[1], w[0], v)
        if rnd == 4:
            return torch.where(L < NL, y, 0)
        top = carry3(t27, t28, t29, torch.zeros_like(v))
        v = i32(y + top * FOLD[0])


def mul_unsqueezed(a, b):
    """The convolution into t[l] (lo) and t[32 + l] (hi) from the
    zero-padded copy of b, four partial sums a digit; the windowed passes;
    the fold of t[30..60] read back as broadcasts, four partial sums."""
    bz = torch.zeros((96,) + b.shape[1:], dtype=b.dtype)
    bz[32:64] = b  # the kernel's pairs pz[k] = (bz[k], bz[k + 32])
    lo4, hi4 = [torch.zeros_like(a) for _ in range(4)], [torch.zeros_like(a) for _ in range(4)]
    for i in range(NL):
        lo4[i % 4] = i32(lo4[i % 4] + a[i] * lds(bz, 32 + L - i))
        hi4[i % 4] = i32(hi4[i % 4] + a[i] * lds(bz, 64 + L - i))
    lo = i32((lo4[0] + lo4[1]) + (lo4[2] + lo4[3]))
    hi = i32((hi4[0] + hi4[1]) + (hi4[2] + hi4[3]))
    wl, wh = [], []
    for k in (1, 2, 3):
        rl, rh = shfl(lo, (L - k) % 32), shfl(hi, (L - k) % 32)
        wl.append(torch.where(L >= k, rl, 0))
        wh.append(torch.where(L >= k, rh, rl))
    lo = carry3(wl[2], wl[1], wl[0], lo)
    hi = carry3(wh[2], wh[1], wh[0], hi)  # lanes 29..31 (positions 61..) unread
    acc = [lo, lo[30] * FOLD[0], lo[31] * FOLD[1], torch.zeros_like(lo)]
    for j in range(29):
        acc[j % 4] = i32(acc[j % 4] + hi[j] * FOLD[2 + j])
    return i32((acc[0] + acc[1]) + (acc[2] + acc[3]))


def mul(a, b):
    return squeeze(mul_unsqueezed(a, b))


def add(a, b):
    return squeeze(a + b)


def sub(a, b):
    return squeeze(a + (2 * MASK - b) + SUBC)


def run_op(slots, op, bit, inf, binf):
    """One table operation on the slot lane tensors (32, R)."""
    kind, dst, a, b, c, _ = op
    if kind == S.SEL:
        res = torch.where(inf, slots[a], torch.where(binf, slots[b], slots[c]))
        slots[dst] = torch.where(bit, res, slots[b])
    else:
        slots[dst] = (mul, add, sub)[kind](slots[a], slots[b])


def walk(sched, run):
    """The kernel's flag discipline over one step: every warp walks its own
    list, an operation runs (``run(op)``) once the operands it waits for
    (those another warp computes) are flagged, the warps take turns in the
    order the flags allow.  Asserts that no warp waits forever, that an
    operand it does not wait for is already written, and that a select
    never overwrites an accumulator slot that an operation still to run
    reads."""
    ready = set()
    pos = [0] * sched.warps
    while any(p < len(ls) for p, ls in zip(pos, sched.lists)):
        moved = False
        for w, ls in enumerate(sched.lists):
            while pos[w] < len(ls):
                op = ls[pos[w]]
                srcs = op[2:5] if op[0] == S.SEL else op[2:4]
                waits = [s for k, s in enumerate(srcs) if op[5] >> k & 1]
                if any(s not in ready for s in waits):
                    break
                # what the kernel does not wait for is already there
                assert all(s < sched.first_temp or s in ready for s in srcs), \
                    "an operand is read before its warp wrote it"
                if op[0] == S.SEL:
                    pending = [o for v, lv in zip(pos, sched.lists) for o in lv[v:]
                               if o is not op and o[0] != S.SEL]
                    assert not any(op[1] in o[2:4] for o in pending), \
                        "a select overwrites a live accumulator slot"
                else:
                    assert op[1] not in ready, "a slot written twice in a step"
                run(op)
                ready.add(op[1])
                pos[w] += 1
                moved = True
        assert moved, "the warps' lists deadlock"


def lane_step(sched, slots, inf, base_inf, bit):
    """One step of ladder_lazy.cu from its tables on the slot lane tensors;
    inf, base_inf, bit: (R,).  Returns the next inf."""
    walk(sched, lambda op: run_op(slots, op, bit, inf, base_inf))
    return torch.where(bit, inf & base_inf, inf)


def lane_prologue(sched, slots):
    for op in sched.prologue:
        run_op(slots, op, False, False, False)


def to_lanes(cols):
    """(NL, R) digit columns → (32, R) int64 lanes, 0 on lanes 30 and 31."""
    return torch.cat([cols.long(), torch.zeros((2, cols.shape[1]), dtype=torch.int64)])


def from_lanes(x):
    assert not x[NL:].any(), "lanes 30 and 31 must hold 0 between operations"
    return x[:NL].to(torch.int32)


def slots_of(sched, acc, base):
    """The kernel's slots from (X, Y, Z) columns: acc, then base, in
    (x, y, z) × (re, im) order; the rest filled by the prologue and steps."""
    def comps(pt):
        if sched.n_acc == 3:
            return [to_lanes(c) for c in pt]
        R = pt[0].shape[1] // 2
        return [to_lanes(h) for c in pt for h in (c[:, :R], c[:, R:])]
    slots = [None] * sched.n_slots
    slots[: 2 * sched.n_acc] = comps(acc) + comps(base)
    return slots


def acc_of(sched, slots):
    """The accumulator slots back as (X, Y, Z) columns."""
    parts = [from_lanes(slots[k]) for k in range(sched.n_acc)]
    if sched.n_acc == 3:
        return tuple(parts)
    return tuple(torch.cat(parts[2 * c: 2 * c + 2], dim=1) for c in range(3))


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


def test_windowed_carries_match_three_passes():
    """The product's windowed passes over the 32 + 32 layout against the
    plain three passes over 61 digits, at sums up to the int32 limit."""
    rng = np.random.default_rng(60)
    t = rng.integers(0, INT32_LIMIT, (61, 16)).astype(np.int64)
    t[59:, :] = 0  # the convolution never reaches digits 59 and 60
    t[:, 0] = INT32_LIMIT - 1
    t[59:, 0] = 0
    ref = F._carry_rough(torch.from_numpy(t).to(torch.int32).clone())
    lo = torch.from_numpy(t[:32])
    hi = torch.zeros((32, 16), dtype=torch.int64)
    hi[:29] = torch.from_numpy(t[32:])
    wl, wh = [], []
    for k in (1, 2, 3):
        rl, rh = shfl(lo, (L - k) % 32), shfl(hi, (L - k) % 32)
        wl.append(torch.where(L >= k, rl, 0))
        wh.append(torch.where(L >= k, rh, rl))
    got_lo = carry3(wl[2], wl[1], wl[0], lo)
    got_hi = torch.where(L < 29, carry3(wh[2], wh[1], wh[0], hi), 0)
    assert torch.equal(torch.cat([got_lo, got_hi[:29]]).to(torch.int32), ref)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_ladder_step_matches_plain_step(group):
    """One step (double, raw add, the selects, inf) from the kernel's
    tables at 4 rows, with every (bit, inf, base_inf) combination that
    changes the result."""
    rng = np.random.default_rng(62 if group == "g1" else 63)
    R = 4
    width = 2 * R if group == "g2" else R
    acc = tuple(_digits(rng, (NL, width)) for _ in range(3))
    base = tuple(_digits(rng, (NL, width)) for _ in range(3))
    inf = torch.tensor([False, True, False, False])
    base_inf = torch.tensor([False, False, True, False])
    bit = torch.tensor([True, True, True, False])

    ops = G.LAZY_FP2_OPS if group == "g2" else G.LAZY_FP_OPS
    ref, ref_inf = G.ladder_step(ops, acc, inf, base, base_inf, bit)

    sched = S.build(group)
    slots = slots_of(sched, acc, base)
    lane_prologue(sched, slots)
    got_inf = lane_step(sched, slots, inf, base_inf, bit)
    assert torch.equal(got_inf, ref_inf)
    for g, r in zip(acc_of(sched, slots), ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_cpu_dispatch_is_the_plain_ladder(group):
    """``scalar_mul_lazy`` on CPU tensors against the lane model of the
    kernel's whole loop (acc = 0 with inf set, the prologue, then
    ``lane_step`` MSB first): a zero scalar, a base_inf row and two finite
    rows, 6 bits."""
    rng = random.Random(64)
    if group == "g2":
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

    sched = S.build(group)
    slots = slots_of(sched, tuple(torch.zeros_like(c) for c in pt), pt)
    lane_prologue(sched, slots)
    inf = torch.ones(len(pts), dtype=torch.bool)
    for i in reversed(range(bits.shape[1])):
        inf = lane_step(sched, slots, inf, base_inf, bits[:, i].bool())
    assert torch.equal(inf, got_inf)
    for g, r in zip(acc_of(sched, slots), got):
        assert torch.equal(g, r)


def test_schedule_header_is_current():
    """csrc/ladder_schedule.h is what ops/ladder_schedule.py generates."""
    with open(S.HEADER) as fh:
        assert fh.read() == S.header()


@pytest.mark.parametrize("warps", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_schedule_runs_every_operation_once_at_any_width(group, warps):
    """At any warp count the lists hold every operation of the step once,
    never deadlock under the flags and never overwrite a live slot.  The
    kinds are the plain step's (G1: 23 products, 15 sums, 10 differences;
    G2 in Fp: 60, 90, 57) less the prologue's (G1: Z2²; G2: Z2² — 2
    products, 2 sums, 1 difference — and 6 Karatsuba sums of base
    coordinates) and, in G2, 7 Karatsuba sums of step values that occur
    twice and run once; plus one select per accumulator digit column."""
    sched = S._schedule(group, warps)
    seen = []
    walk(sched, seen.append)
    assert sorted(seen) == sorted(op for ls in sched.lists for op in ls)
    kinds = [op[0] for op in seen]
    want = {"g1": (22, 15, 10, 3), "g2": (58, 75, 56, 6)}[group]
    assert tuple(kinds.count(k) for k in (S.MUL, S.ADD, S.SUB, S.SEL)) == want
    assert len({op[1] for op in seen if op[0] != S.SEL}) == sched.n_slots - sched.first_temp


@pytest.mark.parametrize("warps", [1, 3, 8])
@pytest.mark.parametrize("kind", ["dbl", "addp"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_tables_run_every_operation_once(group, kind, warps):
    """The windowed kernel's tables without selects at any width: every
    operation once, no deadlock under the flags, the base block the step
    table's, and the kinds of the plain formulas in G1 (dbl: 7 products,
    10 sums, 4 differences; addp: 15 products — Z2² is the prologue's — 5
    sums, 6 differences)."""
    sched = S._schedule(group, warps, kind)
    step = S._schedule(group, warps)
    assert (sched.n_acc, sched.first_temp, sched.prologue) == \
        (step.n_acc, step.first_temp, step.prologue)
    seen = []
    walk(sched, seen.append)
    assert sorted(seen) == sorted(op for ls in sched.lists for op in ls)
    kinds = [op[0] for op in seen]
    assert S.SEL not in kinds and len(sched.outs) == sched.n_acc
    assert all(o >= sched.first_temp for o in sched.outs)
    if group == "g1":
        want = {"dbl": (7, 10, 4), "addp": (15, 5, 6)}[kind]
        assert tuple(kinds.count(k) for k in (S.MUL, S.ADD, S.SUB)) == want


@pytest.mark.parametrize("kind", ["dbl", "addp"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_window_tables_match_plain(group, kind):
    """One dbl (``point_double`` of acc) and one addp (``point_add_raw`` of
    acc and base) from the kernel's tables at 3 rows, digit-exact."""
    rng = np.random.default_rng(67 if group == "g1" else 68)
    R = 3
    width = 2 * R if group == "g2" else R
    acc = tuple(_digits(rng, (NL, width)) for _ in range(3))
    base = tuple(_digits(rng, (NL, width)) for _ in range(3))
    ops = G.LAZY_FP2_OPS if group == "g2" else G.LAZY_FP_OPS
    ref = G.point_double(ops, acc) if kind == "dbl" else G.point_add_raw(ops, acc, base)

    sched = S.build(group, kind)
    slots = slots_of(sched, acc, base)
    lane_prologue(sched, slots)
    walk(sched, lambda op: run_op(slots, op, None, None, None))
    slots[:sched.n_acc] = [slots[o] for o in sched.outs]
    for g, r in zip(acc_of(sched, slots), ref):
        assert torch.equal(g, r)


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
