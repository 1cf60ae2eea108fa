"""The ladder kernels' design against the reference, on the CPU.

``csrc/fp_lazy.cuh``, ``csrc/ladder_lazy.cu`` and ``csrc/ladder_window.cu``
run only on the card.  Here a lane model of them — at K field elements a
warp (K = 1, 2, 4), an element's 32/K lanes as the first tensor axis and a
lane's K digits as the second, a shuffle as a gather along the lanes, a
shared-memory row as a (32, rows) tensor — follows the device functions
step for step: the product (the cyclic, output-stationary convolution at
K > 1, the zero-padded pairs at K = 1), the windowed carry passes, the
squeeze's five rounds with one exchange each.  It is held digit-exact
against the plain field (``fp_lazy.mul_lazy_cols``, ``fp381``'s lazy
add/sub/neg).  The ladder step runs from the kernels' own tables
(``ops/ladder_schedule.py``, the source of ``csrc/ladder_schedule.h``):
the prologue, then every warp's operation list with versioned ready flags,
warps interleaved as the flags allow (first-ready, or at random), reading
one accumulator set and writing the other, against one G1 and one G2 step
of the plain ladder and over a short whole ladder against the CPU side of
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
INT32_LIMIT = 1 << 31
KS = (1, 2, 4)  # field elements a warp

# the residue rows (31, 32 positions) and the sub constant, 0 at 30 and 31
FOLD = torch.zeros((NL + 1, 32, 1), dtype=torch.int64)
FOLD[:, :NL, 0] = torch.from_numpy(F._FOLD_HI.astype(np.int64))
SUBC = torch.zeros((32, 1), dtype=torch.int64)
SUBC[:NL, 0] = torch.from_numpy(F._SUBC_LIMBS.astype(np.int64))


def i32(x):
    assert int(x.abs().max()) < INT32_LIMIT, "an int32 sum of the kernel would wrap"
    return x


class Lanes:
    """fp_lazy.cuh's layout at K elements a warp: an element's G = 32/K
    lanes as the first axis, a lane's K digits the second, the elements
    (rows) the last; position p = K·j + m.  Shuffles stay inside an
    element's lanes, so the model runs every element's group side by
    side.  Per-lane constants as FieldLane<K> holds them."""

    def __init__(self, K):
        self.K, self.G = K, 32 // K
        self.j = torch.arange(self.G)[:, None, None]
        pos = (K * self.j + torch.arange(K)[None, :, None])  # (G, K, 1)
        self.keep = pos < NL
        self.below = [K * self.j >= d for d in range(4)]  # (G, 1, 1)
        self.row0 = FOLD[0].reshape(self.G, K, 1)
        pos0 = K * torch.arange(self.G)
        self.row0w = [None] + [torch.where(pos0 >= d, FOLD[0, (pos0 - d).clamp(min=0), 0], 0)[:, None]
                               for d in (1, 2, 3)]  # row 0 at the window's positions
        self.subk = torch.where(self.keep, 2 * MASK + SUBC.reshape(self.G, K, 1), 0)
        self.fold = FOLD.reshape(NL + 1, self.G, K, 1)

    def lanes(self, row):
        """A shared-memory row (32, N) as this lane's digits (G, K, N)."""
        return row.reshape(self.G, self.K, -1)

    def row(self, v):
        return v.reshape(32, -1)

    def carry_window(self, w, v):
        """Three passes over the window w[3], w[2], w[1], v[0 .. K) (each
        (G, N)), as carry_window."""
        x = [w[3], w[2], w[1]] + [v[:, m] for m in range(self.K)]
        for p in (1, 2, 3):
            for q in range(self.K + 2, p - 1, -1):
                x[q] = i32((x[q] & MASK) + (x[q - 1] >> BITS))
        return torch.stack(x[3:], dim=1)

    def window_below(self, v):
        """__shfl_up_sync within the group, lanes below digit 0 masked."""
        w = [None] * 4
        for d in (1, 2, 3):
            off = -(-d // self.K)
            x = v[:, self.K * off - d]
            up = torch.cat([x[:off], x[:-off]])
            w[d] = torch.where(self.below[d][:, 0], up, 0)
        return w

    def squeeze(self, v):
        """Five rounds of passes; between two, one exchange brings digit 30
        (one lane's, broadcast) and the next window (the lower lanes'
        digits after the passes), and the lane folds both."""
        i32(v)
        w = self.window_below(v)
        for rnd in range(5):
            v = self.carry_window(w, v)
            if rnd == 4:
                break
            top = v[NL // self.K, NL % self.K]
            w = self.window_below(v)
            v = i32(torch.where(self.keep, v, 0) + top * self.row0)
            w = [None] + [i32(w[d] + top * self.row0w[d]) for d in (1, 2, 3)]
        return torch.where(self.keep, v, 0)

    def mul_unsqueezed(self, a, b):
        """K > 1: the cyclic convolution, output-stationary: step s
        multiplies the chunk (j − s) mod G of a by b's digits around Ks; the
        low half is the sum snapshot at s = j, the high half the rest (K =
        1: the zero-padded pairs); then the three passes and the fold of t[30 .. 60] (broadcast) in 4 (K = 1) or 2
        partial sums a digit."""
        K, G, j = self.K, self.G, self.j
        if K == 1:
            lo, hi = self._conv_pairs(a, b)
            return self._fold(*self.carries(lo, hi))
        A, B = self.lanes(a), self.lanes(b)
        acc = torch.zeros_like(A)
        lo = torch.zeros_like(A)
        # terms (m, r): b digit Ks + m − r, the window's entry K + m − r;
        # at s = 0 the terms with m < r wrap to the high half, where only
        # b[29] is not zero (m − r = −3)
        m_r = torch.arange(K)[:, None] - torch.arange(K)[None, :]
        low = (m_r >= 0).long()[None, :, :, None]
        wrap_t = (m_r == -3).long()[None, :, :, None]
        bprev = B[G - 1]
        wrap = torch.zeros_like(A)
        for s in range(G):
            ach = A[(torch.arange(G) - s) % G]  # (G, r, N)
            bmat = torch.cat([bprev, B[s]])[K + m_r]  # (m, r, N)
            terms = ach[:, None, :, :] * bmat[None]  # (G, m, r, N)
            if s == 0:
                wrap = i32((terms * wrap_t).sum(2))
                terms = terms * low
            acc = i32(acc + terms.sum(2))
            lo = torch.where(j == s, acc, lo)
            bprev = B[s]
        return self._fold(*self.carries(lo, i32(acc - lo + wrap)))

    def _conv_pairs(self, a, b):
        """K = 1: lane l sums a[i]·b[l − i] (low) and a[i]·b[l + 32 − i]
        (high) from the zero-padded pairs pz[k] = (bz[k], bz[k + 32]),
        four partial sums each."""
        bz = torch.zeros((96,) + b.shape[1:], dtype=b.dtype)
        bz[32:64] = b
        lanes = torch.arange(32)[:, None]
        lo4 = [torch.zeros_like(a) for _ in range(4)]
        hi4 = [torch.zeros_like(a) for _ in range(4)]
        for i in range(NL):
            lo4[i % 4] = i32(lo4[i % 4] + a[i] * torch.gather(bz, 0, (32 + lanes - i).expand_as(a)))
            hi4[i % 4] = i32(hi4[i % 4] + a[i] * torch.gather(bz, 0, (64 + lanes - i).expand_as(a)))
        lo = i32((lo4[0] + lo4[1]) + (lo4[2] + lo4[3]))
        hi = i32((hi4[0] + hi4[1]) + (hi4[2] + hi4[3]))
        return self.lanes(lo), self.lanes(hi)

    def _fold(self, lo, hi):
        K = self.K
        flo, fhi = self.row(lo), self.row(hi)
        t = [flo[30], flo[31]] + [fhi[i] for i in range(29)]  # t30 .. t60
        P = 4 if K == 1 else 2
        sums = [torch.where(self.keep, lo, 0)] + [torch.zeros_like(lo)] * (P - 1)
        for jj in range(NL + 1):
            sums[jj % P] = i32(sums[jj % P] + t[jj] * self.fold[jj])
        return i32(sum(sums[1:], sums[0]))

    def carries(self, lo, hi):
        """Three passes over the 64 positions: the low half's window from
        the low digits below, the high half's from the high digits below
        or, for its first digits, the low half's top (a rotating shuffle)."""
        K = self.K
        wl, wh = [None] * 4, [None] * 4
        for d in (1, 2, 3):
            off = -(-d // K)
            rl, rh = (torch.roll(x[:, K * off - d], off, 0) for x in (lo, hi))
            wl[d] = torch.where(self.below[d][:, 0], rl, 0)
            wh[d] = torch.where(self.below[d][:, 0], rh, rl)
        return self.carry_window(wl, lo), self.carry_window(wh, hi)

    def mul(self, a, b):
        return self.row(self.squeeze(self.mul_unsqueezed(a, b)))

    def add(self, a, b):
        return self.row(self.squeeze(self.lanes(a) + self.lanes(b)))

    def sub(self, a, b):
        return self.row(self.squeeze(self.lanes(a) + self.subk - self.lanes(b)))


LANES = {K: Lanes(K) for K in KS}


def versions(op):
    """The source versions (a, b, c) and the destination's of an op."""
    return [(op[6] >> 3 * k) & 7 for k in range(3)], (op[6] >> 9) & 7


class Frame:
    """ladder_steps.cuh's Frame: slot id → ``rows`` (the accumulator sets A
    and B, then the temporaries), or, for an operand flagged base, the
    base point's coordinate (``base``, s < n_acc) or the prologue's value
    (``pro``)."""

    def __init__(self, rows, base, pro, n_acc):
        self.rows, self.base, self.pro, self.n = rows, base, pro, n_acc

    def _at(self, flag, s):
        if not flag:
            return self.rows, s
        return (self.base, s) if s < self.n else (self.pro, s - self.n)

    def get(self, op, k):
        """Operand k of op (0, 1, 2: a, b, c; 3: dst)."""
        lst, i = self._at(op[5] >> (4 + k) & 1, op[1 + (k + 1) % 4])
        return lst[i]

    def put(self, op, v):
        lst, i = self._at(op[5] >> 7 & 1, op[1])
        lst[i] = v


def run_op(lanes, fr, op, bit, inf, binf):
    """One table operation on the slot rows (32, R)."""
    kind = op[0]
    a, b = fr.get(op, 0), fr.get(op, 1)
    if kind == S.SEL:
        res = torch.where(inf, a, torch.where(binf, b, fr.get(op, 2)))
        fr.put(op, torch.where(bit, res, b))
    else:
        fr.put(op, (lanes.mul, lanes.add, lanes.sub)[kind](a, b))


def walk(sched, run, rng=None):
    """The kernel's flag discipline over one step: every warp walks its own
    list; an operation runs (``run(op)``) once the operands it waits for
    (another warp's) are flagged with the version it reads; one warp at a
    time, the first that can go, or a random one (``rng``).  Asserts that
    no warp waits forever, that every operand holds the very write the op
    reads (not an older one, not a newer one), and that no write replaces
    a value an operation still to run reads."""
    cur = {}  # slot → which write of this step it holds
    pos = [0] * sched.warps
    left = len([op for ls in sched.lists for op in ls])

    def srcs(op):
        vers, _ = versions(op)
        n = 3 if op[0] == S.SEL else 2
        return [(op[2 + k], vers[k], op[5] >> k & 1, op[5] >> (4 + k) & 1) for k in range(n)]

    pending = {}  # (slot, version) → reads still to run; base rows as ("base", row)
    for ls in sched.lists:
        for op in ls:
            for s, v, _, b in srcs(op):
                key = ("base", s) if b else s
                pending[key, v] = pending.get((key, v), 0) + 1

    def can_go(op):
        return all(cur.get(("base", s) if b else s, 0) >= v for s, v, w, b in srcs(op) if w)

    while left:
        ready = [w for w, ls in enumerate(sched.lists)
                 if pos[w] < len(ls) and can_go(ls[pos[w]])]
        assert ready, "the warps' lists deadlock"
        w = ready[0] if rng is None else rng.choice(ready)
        op = sched.lists[w][pos[w]]
        for s, v, _, base in srcs(op):
            key = ("base", s) if base else s
            if v == 0:
                assert base or s in sched.in_rows, "a value of the step read without its version"
            else:
                assert cur.get(key) == v, "an operand read before its write, or after the next"
        left -= 1
        for s, v, _, b in srcs(op):
            pending[("base", s) if b else s, v] -= 1
        _, dv = versions(op)
        if op[5] >> 7 & 1:  # dblpro: a prologue value of the next step's base block
            assert op[0] != S.SEL and op[1] >= sched.n_acc and dv == 1, \
                "a step writes a base coordinate"
            assert not pending.get((("base", op[1]), 0)), "a base row replaced while read"
            cur["base", op[1]] = dv
        elif op[0] == S.SEL:
            assert op[1] in sched.out_rows and dv == 0
        else:
            assert op[1] not in sched.in_rows, "a step writes the set it reads"
            assert cur.get(op[1], 0) == dv - 1, "a slot's writes out of order"
            assert not pending.get((op[1], dv - 1)), \
                "a write replaces a value an operation still to run reads"
            cur[op[1]] = dv
        run(op)
        pos[w] += 1


def lane_step(lanes, sched, fr, inf, base_inf, bit):
    """One step of a table on its frame; inf, base_inf, bit: (R,).
    Returns the next inf."""
    walk(sched, lambda op: run_op(lanes, fr, op, bit, inf, base_inf))
    return torch.where(bit, inf & base_inf, inf)


def lane_prologue(lanes, sched, fr):
    for op in sched.prologue:
        run_op(lanes, fr, op, False, False, False)


def to_lanes(cols, row=32):
    """(NL, R) digit columns → (row, R) int64 rows, 0 from NL (the 13-bit
    field's rows of 32; the 8-bit field's of 64)."""
    return torch.cat([cols.long(),
                      torch.zeros((row - cols.shape[0], cols.shape[1]), dtype=torch.int64)])


def from_lanes(x, nl=NL):
    assert not x[nl:].any(), "the positions from NL must hold 0 between operations"
    return x[:nl].to(torch.int32)


def comps(n_acc, pt, row=32):
    """(X, Y, Z) columns as the n_acc slot rows, (x, y, z) × (re, im)."""
    if n_acc == 3:
        return [to_lanes(c, row) for c in pt]
    R = pt[0].shape[1] // 2
    return [to_lanes(h, row) for c in pt for h in (c[:, :R], c[:, R:])]


def point_of(n_acc, rows, nl=NL):
    """Slot rows back as (X, Y, Z) columns."""
    parts = [from_lanes(x, nl) for x in rows]
    if n_acc == 3:
        return tuple(parts)
    return tuple(torch.cat(parts[2 * c: 2 * c + 2], dim=1) for c in range(3))


def frame_of(sched, acc, base, row=32):
    """A frame for one step of ``sched``: acc in the set it reads, base's
    coordinates in the base block (the prologue fills the rest)."""
    rows = [None] * sched.n_slots
    rows[sched.in_rows.start:sched.in_rows.stop] = comps(sched.n_acc, acc, row)
    return Frame(rows, comps(sched.n_acc, base, row), [None] * (sched.entry_rows - sched.n_acc),
                 sched.n_acc)


def result(sched, fr, nl=NL):
    """The point a step wrote, from the set it writes."""
    return point_of(sched.n_acc, fr.rows[sched.out_rows.start:sched.out_rows.stop], nl)


def _digits(rng, shape, extreme_cols=1):
    """Lazy-invariant digits in [0, 2^13]; the first columns all 2^13."""
    d = rng.integers(0, (1 << BITS) + 1, shape).astype(np.int32)
    d[:, :extreme_cols] = 1 << BITS
    return torch.from_numpy(d)


@pytest.mark.parametrize("K", KS)
def test_lane_model_mul_add_sub_digit_exact(K):
    rng = np.random.default_rng(61)
    a, b = _digits(rng, (NL, 48)), _digits(rng, (NL, 48))
    a[:, 1] = 0
    fold = F.consts("cpu").fold
    la, lb, lanes = to_lanes(a), to_lanes(b), LANES[K]
    assert torch.equal(from_lanes(lanes.mul(la, lb)), fp_lazy.mul_lazy_cols(a, b, fold))
    assert torch.equal(from_lanes(lanes.mul(la, la)), fp_lazy.mul_lazy_cols(a, a, fold))
    assert torch.equal(from_lanes(lanes.add(la, lb)), F.fp_add_lazy(a, b))
    assert torch.equal(from_lanes(lanes.sub(la, lb)), F.fp_sub_lazy(a, b))
    assert torch.equal(from_lanes(lanes.sub(torch.zeros_like(la), la)), F.fp_neg_lazy(a))


@pytest.mark.parametrize("K", KS)
def test_windowed_carries_match_three_passes(K):
    """The product's windowed passes over the low and high halves (64
    positions) against the plain three passes over 61 digits, at sums up
    to the int32 limit."""
    rng = np.random.default_rng(60)
    t = rng.integers(0, INT32_LIMIT, (61, 16)).astype(np.int64)
    t[59:, :] = 0  # the convolution never reaches digits 59 and 60
    t[:, 0] = INT32_LIMIT - 1
    t[59:, 0] = 0
    ref = F._carry_rough(torch.from_numpy(t).to(torch.int32).clone())
    lanes = LANES[K]
    lo = lanes.lanes(torch.from_numpy(t[:32]))
    hi = torch.zeros((32, 16), dtype=torch.int64)
    hi[:29] = torch.from_numpy(t[32:])
    lo, hi = lanes.carries(lo, lanes.lanes(hi))
    got = torch.cat([lanes.row(lo), lanes.row(hi)[:29]])
    assert torch.equal(got.to(torch.int32), ref)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_ladder_step_matches_plain_step(group, K):
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
    fr = frame_of(sched, acc, base)
    lanes = LANES[K]
    lane_prologue(lanes, sched, fr)
    got_inf = lane_step(lanes, sched, fr, inf, base_inf, bit)
    assert torch.equal(got_inf, ref_inf)
    for g, r in zip(result(sched, fr), ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_cpu_dispatch_is_the_plain_ladder(group):
    """``scalar_mul_lazy`` on CPU tensors against the lane model of the
    bitwise kernel's whole loop at K = 1 (acc = 0 with inf set, the
    prologue, then a step a bit, MSB first, reading one accumulator set
    and writing the other): a zero scalar, a base_inf row and two finite
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

    ab, ba, lanes = S.build(group, "step", "AB"), S.build(group, "step", "BA"), LANES[1]
    fr = frame_of(ab, tuple(torch.zeros_like(c) for c in pt), pt)
    lane_prologue(lanes, ab, fr)
    inf = torch.ones(len(pts), dtype=torch.bool)
    for i in range(bits.shape[1]):
        sched = ab if i % 2 == 0 else ba
        inf = lane_step(lanes, sched, fr, inf, base_inf, bits[:, -1 - i].bool())
    assert torch.equal(inf, got_inf)
    for g, r in zip(result(sched, fr), got):
        assert torch.equal(g, r)


def test_schedule_header_is_current():
    """csrc/ladder_schedule.h is what ops/ladder_schedule.py generates."""
    with open(S.HEADER) as fh:
        assert fh.read() == S.header()


def _writes(sched):
    """(slot, version) of every write of a table, and the ops' kinds."""
    ops = [op for ls in sched.lists for op in ls]
    return ([(("base", op[1]) if op[5] >> 7 & 1 else op[1], versions(op)[1]) for op in ops],
            [op[0] for op in ops])


def _swap_sets(sched, op):
    """op with rows of A and B exchanged (base rows stay)."""
    n = sched.n_acc
    swap = [(x + n if x < n else x - n) if x < 2 * n else x for x in op[1:5]]
    flags = op[5]
    for k, i in enumerate((2, 3, 4, 1)):  # a, b, c, dst: base-flagged rows stay
        if flags >> (4 + k) & 1 or (i == 4 and op[0] != S.SEL):  # c: a select's only
            swap[i - 1] = op[i]
    return (op[0], *swap, op[5], op[6])


def _check_tables(sched, other):
    """``other`` is ``sched`` with the accumulator sets exchanged."""
    assert other.sets != sched.sets
    assert [[_swap_sets(sched, op) for op in ls] for ls in sched.lists] == \
        [list(ls) for ls in other.lists]


@pytest.mark.parametrize("warps", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_schedule_runs_every_operation_once_at_any_width(group, warps):
    """At any warp count the lists hold every operation of the step once,
    never deadlock under the flags and never replace a value still to be
    read, in the first-ready order and in three random interleavings.
    The kinds are the plain step's (G1: 23 products, 15 sums, 10
    differences; G2 in Fp: 60, 90, 57) less the prologue's (G1: Z2²; G2:
    Z2² — 2 products, 2 sums, 1 difference — and 6 Karatsuba sums of base
    coordinates) and, in G2, 7 Karatsuba sums of step values that occur
    twice and run once; plus one select per accumulator digit column, each
    writing its own row of the set the step writes.  Every other write is
    a distinct (slot, version) of the temporaries.  The B→A table is the
    A→B one with the sets exchanged."""
    sched = S._schedule(group, warps)
    for seed in (None, 0, 1, 2):
        seen = []
        walk(sched, seen.append, None if seed is None else random.Random(seed))
        assert sorted(seen) == sorted(op for ls in sched.lists for op in ls)
    writes, kinds = _writes(sched)
    want = {"g1": (22, 15, 10, 3), "g2": (58, 75, 56, 6)}[group]
    assert tuple(kinds.count(k) for k in (S.MUL, S.ADD, S.SUB, S.SEL)) == want
    assert len(set(writes)) == len(writes)
    sels = sorted(w[0] for w, k in zip(writes, kinds) if k == S.SEL)
    assert sels == list(sched.out_rows)
    assert all(s >= 2 * sched.n_acc for (s, _), k in zip(writes, kinds) if k != S.SEL)
    _check_tables(sched, S._schedule(group, warps, "step", "BA"))


@pytest.mark.parametrize("warps", [1, 3, 8])
@pytest.mark.parametrize("kind", ["dbl", "addp", "dblpro"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_tables_run_every_operation_once(group, kind, warps):
    """The windowed kernel's tables without selects at any width: every
    operation once, no deadlock under the flags, no value replaced before
    its last read (first-ready and two random interleavings), the step
    table's rows and base block, each row of the set written once, and
    the kinds of the plain formulas in G1 (dbl: 7 products, 10 sums, 4
    differences; addp: 15 products — Z2² is the prologue's — 5 sums, 6
    differences; dblpro: dbl and the prologue's Z2²)."""
    sched = S._schedule(group, warps, kind)
    step = S._schedule(group, warps)
    assert (sched.n_acc, sched.n_temps, sched.entry_rows, sched.prologue) == \
        (step.n_acc, step.n_temps, step.entry_rows, step.prologue)
    for seed in (None, 3, 4):
        seen = []
        walk(sched, seen.append, None if seed is None else random.Random(seed))
        assert sorted(seen) == sorted(op for ls in sched.lists for op in ls)
    writes, kinds = _writes(sched)
    assert S.SEL not in kinds and len(set(writes)) == len(writes)
    outs = sorted(s for s, _ in writes if isinstance(s, int) and s in sched.out_rows)
    assert outs == list(sched.out_rows)
    if group == "g1":
        want = {"dbl": (7, 10, 4), "addp": (15, 5, 6), "dblpro": (8, 10, 4)}[kind]
        assert tuple(kinds.count(k) for k in (S.MUL, S.ADD, S.SUB)) == want
    if kind == "dblpro":  # the prologue's ops, each once, writing its base rows
        pro = [op for ls in sched.lists for op in ls if op[5] >> 7 & 1]
        assert sorted(op[:5] for op in pro) == sorted(op[:5] for op in sched.prologue)
    if kind == "dbl":
        _check_tables(sched, S._schedule(group, warps, kind, "BA"))


@pytest.mark.parametrize("kind", ["dbl", "addp"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_window_tables_match_plain(group, kind):
    """One dbl (``point_double`` of acc) and one addp (``point_add_raw`` of
    acc and base) from the kernel's tables at 3 rows, K = 4, the result in
    the set the table writes, digit-exact."""
    rng = np.random.default_rng(67 if group == "g1" else 68)
    R = 3
    width = 2 * R if group == "g2" else R
    acc = tuple(_digits(rng, (NL, width)) for _ in range(3))
    base = tuple(_digits(rng, (NL, width)) for _ in range(3))
    ops = G.LAZY_FP2_OPS if group == "g2" else G.LAZY_FP_OPS
    ref = G.point_double(ops, acc) if kind == "dbl" else G.point_add_raw(ops, acc, base)

    for g, r in zip(lane_table(group, kind, LANES[4], acc, base), ref):
        assert torch.equal(g, r)


def lane_table(group, kind, lanes, acc, base, row=32, nl=NL):
    """One table of ``kind`` (dbl or addp) from the kernel's tables on a
    lane model of a field (``lanes``: its mul, add and sub on rows of
    ``row`` words), the prologue first; the point it wrote."""
    sched = S.build(group, kind)
    fr = frame_of(sched, acc, base, row)
    lane_prologue(lanes, sched, fr)
    walk(sched, lambda op: run_op(lanes, fr, op, None, None, None))
    return result(sched, fr, nl)


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
