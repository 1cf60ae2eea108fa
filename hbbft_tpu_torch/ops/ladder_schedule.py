"""The ladder kernels' step schedules: one set of tables for the kernels and
their lane model.

One ladder step (:func:`hbbft_tpu_torch.ops.gcurve.ladder_step`: the
doubling, the raw addition of the base, the selects) is traced through the
port's own formulas (``gcurve.point_double``, ``gcurve.point_add_raw``)
over a symbolic lazy field into a DAG of Fp operations.  An Fp2 operation
expands into Fp operations exactly as ``ops/fp381.py`` and
``csrc/fp_lazy.cuh`` run it (Karatsuba ``t0 = a0·b0``, ``t1 = a1·b1``,
``t2 = (a0 + a1)(b0 + b1)``; squares as ``(a0 + a1)(a0 − a1)``, ``2·a0·a1``).
Every operation is a function of its operands' digits alone, so the
table may reorder, share and hoist them without changing a digit:

- identical operations (same kind, same operands) are computed once;
- operations whose operands are all base-point values (``Z2²`` and the
  Karatsuba sums of base coordinates) move to a prologue that runs once
  per row before the steps;
- the rest is list-scheduled, longest path first, onto ``W`` warps: each
  warp gets an ordered list of operations.

In the kernels (``csrc/ladder_steps.cuh``) a block runs K rows, and every
value of a step has a slot (a row of K·32 digits in shared memory) and a
ready flag; a warp waits for the flag of each operand that another warp
computes (its own are ready by program order), computes, stores and
raises its destination's flag; the step ends at a block barrier.  An
operation waits only for operations that started earlier in the simulated
schedule, so no warp order can deadlock.  ``SEL`` writes the next
accumulator: ``acc = bit ? (inf ? base : (base_inf ? d : s)) : d``.

Slots are rows: the two accumulator sets A and B, then the temporaries.
A table reads one set and writes the other (``sets``, "AB" or "BA"), so
no step copies its result.  A temporary is reused once every reader of
its value has surely read it — each reader is the new writer, one of its
ancestors, or an earlier operation of its warp — so its flag counts the
writes (``VERSIONS`` at most a step) and a reader waits for the one it
reads.  Operands of the base block (the base point's coordinates, then the
prologue's values) are flagged "base": the kernel points them at the
table entry of each row, in place.

The windowed kernel (``csrc/ladder_window.cu``) runs the step table and
three more: ``dbl`` (``point_double`` of the accumulator alone), ``addp``
(``point_add_raw`` of the accumulator and the base point, for the table's
odd entries) and ``dblpro`` (``dbl`` with the prologue of the next step's
base block scheduled beside it, since a table entry keeps only its
coordinates).

``python -m hbbft_tpu_torch.ops.ladder_schedule`` writes
``csrc/ladder_schedule.h`` from :func:`header`;
``tests/test_torch_ladder.py`` checks that the file is current and runs the
same tables through its lane model.
"""

from __future__ import annotations

import heapq
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

from hbbft_tpu_torch.ops import gcurve as G

MUL, ADD, SUB, SEL = 0, 1, 2, 3
KIND_NAMES = ("MUL", "ADD", "SUB", "SEL")

# Warps per row (one row per block).  The epoch runs 256 G1 and 128 G2
# rows: 768 and 1024 warps on the card's 528 schedulers.
WARPS = {"g1": 3, "g2": 8}

# Cycles of one operation on one warp, for the list scheduler's priorities
# and the simulated start times only: a warp's latency of a chained lazy
# product, sum and difference at K = 4 elements a warp on the H100
# (chip_smoke.py's kernel_field: 682, 199 and 202 ns at 1 980 MHz; PERF.md
# §6); a select, a few loads and stores, is not measured.  The simulated
# step is shorter than the card's, which also waits on flags and shares
# each scheduler among the warps of several blocks.
LATENCY = {MUL: 1350, ADD: 400, SUB: 400, SEL: 60}
OVERHEAD = 80  # flag wait + store + flag raise

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "ladder_schedule.h")


class _Val:
    """A traced Fp value: an input (acc or base digit column) or an op."""

    __slots__ = ("kind", "srcs", "const")

    def __init__(self, kind, srcs, const):
        self.kind, self.srcs, self.const = kind, srcs, const


class _Tracer:
    def __init__(self):
        self.ops: List[_Val] = []
        self._cse: Dict[tuple, _Val] = {}

    def op(self, kind, *srcs):
        key = (kind,) + tuple(id(s) for s in srcs)
        hit = self._cse.get(key)
        if hit is None:
            hit = _Val(kind, srcs, all(s.const for s in srcs))
            self._cse[key] = hit
            self.ops.append(hit)
        return hit


class _SymFp:
    def __init__(self, t):
        self.t = t

    def add(self, a, b):
        return self.t.op(ADD, a, b)

    def sub(self, a, b):
        return self.t.op(SUB, a, b)

    def mul(self, a, b):
        return self.t.op(MUL, a, b)

    def sqr(self, a):
        return self.t.op(MUL, a, a)


class _SymFp2:
    """Fp2 over (re, im) pairs, in fp381's and fp_lazy.cuh's order."""

    def __init__(self, t):
        self.f = _SymFp(t)

    def add(self, a, b):
        return self.f.add(a[0], b[0]), self.f.add(a[1], b[1])

    def sub(self, a, b):
        return self.f.sub(a[0], b[0]), self.f.sub(a[1], b[1])

    def mul(self, a, b):
        f = self.f
        sa, sb = f.add(a[0], a[1]), f.add(b[0], b[1])
        t0, t1, t2 = f.mul(a[0], b[0]), f.mul(a[1], b[1]), f.mul(sa, sb)
        return f.sub(t0, t1), f.sub(t2, f.add(t0, t1))

    def sqr(self, a):
        f = self.f
        t0 = f.mul(f.add(a[0], a[1]), f.sub(a[0], a[1]))
        t1 = f.mul(a[0], a[1])
        return t0, f.add(t1, t1)


KINDS = ("step", "dbl", "addp", "dblpro")  # the tables, see the module docstring
VERSIONS = 7  # writes of one slot in one step, at most (3 bits)


@dataclass(frozen=True)
class Schedule:
    """One group's table of one kind, reading one accumulator set and
    writing the other (``sets``: "AB" reads A, writes B).  Slot ids are
    rows: A is 0 .. n_acc − 1, B n_acc .. 2·n_acc − 1, the temporaries
    from 2·n_acc (``n_temps``, the most any table of the group needs), so
    ``n_slots = 2·n_acc + n_temps``.  The base block (the base point's
    coordinates, then the prologue's results: ``entry_rows`` rows) is apart:
    an operand flagged "base" is row k of the block the kernel points it at
    (a table entry of its own for each row of a block).  An op is ``(kind,
    dst, a, b, c, wait, ver)``: ``c`` only for SEL; bit k of ``wait`` says
    source k is another warp's value of this step, bit 4 + k that source k
    is a base row (bit 7: ``dst``); ``ver`` holds 3 bits a source (which
    write of its slot it reads, bits 0–8) and 3 bits for the write of
    ``dst`` (bits 9–11); 0 for rows written before the step, and for a
    select's ``dst``, which no op of the step reads."""

    warps: int
    n_acc: int
    n_temps: int
    entry_rows: int
    sets: str
    prologue: Tuple[tuple, ...]
    lists: Tuple[Tuple[tuple, ...], ...]  # one ordered op list per warp
    makespan: int  # simulated cycles of one step

    @property
    def n_slots(self) -> int:
        return 2 * self.n_acc + self.n_temps

    @property
    def in_rows(self) -> range:
        return range(0, self.n_acc) if self.sets == "AB" else range(self.n_acc, 2 * self.n_acc)

    @property
    def out_rows(self) -> range:
        return range(self.n_acc, 2 * self.n_acc) if self.sets == "AB" else range(0, self.n_acc)


def _flat(p, fp2):
    return [e for c in p for e in (c if fp2 else (c,))]


def build(group: str, kind: str = "step", sets: str = "AB") -> Schedule:
    """The table ``kind`` (one of ``KINDS``) of ``group`` ("g1"/"g2") on its
    ``WARPS[group]`` warps a row, reading set ``sets[0]`` and writing
    ``sets[1]``."""
    return _schedule(group, WARPS[group], kind, sets)


def _live(t, outs):
    """The traced ops that reach ``outs``, in trace order."""
    live, stack = set(), list(outs)
    while stack:
        v = stack.pop()
        if id(v) not in live:
            live.add(id(v))
            stack.extend(v.srcs)
    return [v for v in t.ops if id(v) in live]


def _schedule(group: str, warps: int, kind: str = "step", sets: str = "AB") -> Schedule:
    plans = {k: _plan(group, warps, k) for k in KINDS}
    n_temps = max(p["n_temps"] for p in plans.values())
    return _encode(plans[kind], warps, n_temps, sets)


def _plan(group: str, warps: int, kind: str) -> dict:
    """Trace, hoist, list-schedule and assign temporaries (reused once every
    reader of their value has surely run) for one table."""
    fp2 = group == "g2"
    t = _Tracer()
    o = _SymFp2(t) if fp2 else _SymFp(t)

    def point(const):
        def el():
            return (_Val(None, (), const), _Val(None, (), const)) if fp2 else _Val(None, (), const)
        return tuple(el() for _ in "xyz")

    acc, base = point(False), point(True)
    d = G.point_double(o, acc)
    s = G.point_add_raw(o, d, base)
    sels = [t.op(SEL, b, dv, sv)
            for dv, sv, b in zip(_flat(d, fp2), _flat(s, fp2), _flat(base, fp2))]
    # the base block is the step's: its prologue, whatever the table
    prologue_vals = [v for v in _live(t, sels) if v.const]
    if kind == "step":
        outs = sels
    elif kind in ("dbl", "dblpro"):
        outs = _flat(d, fp2)
    else:
        outs = _flat(G.point_add_raw(o, acc, base), fp2)
    assert len({id(v) for v in outs}) == len(outs)
    ops = _live(t, outs)
    assert all(id(v) in {id(p) for p in prologue_vals} for v in ops if v.const)
    step_vals = [v for v in ops if not v.const]
    # dblpro: the doubling and, beside it, the next step's prologue, whose
    # values are base rows of their own (flagged like any other value)
    written = prologue_vals if kind == "dblpro" else []
    step_vals += written

    inputs = _flat(acc, fp2) + _flat(base, fp2)
    n_acc = len(inputs) // 2
    first_temp = len(inputs) + len(prologue_vals)
    fixed = {id(v): i for i, v in enumerate(inputs + prologue_vals)}

    # list schedule: longest path to the outputs first
    users: Dict[int, list] = {id(v): [] for v in step_vals}
    for v in step_vals:
        for x in v.srcs:
            if id(x) in users:
                users[id(x)].append(v)
    prio: Dict[int, int] = {}
    for v in reversed(step_vals):
        prio[id(v)] = LATENCY[v.kind] + max([prio[id(u)] for u in users[id(v)]] + [0])
    order = {id(v): i for i, v in enumerate(step_vals)}
    waiting = {id(v): sum(1 for x in v.srcs if id(x) in users) for v in step_vals}
    ready_at = {id(v): 0 for v in step_vals}
    heap = [(-prio[id(v)], order[id(v)], v) for v in step_vals if waiting[id(v)] == 0]
    heapq.heapify(heap)
    free = [0] * warps
    lists: List[List[_Val]] = [[] for _ in range(warps)]
    warp_of: Dict[int, int] = {}
    finish: Dict[int, int] = {}
    popped: List[_Val] = []
    while heap:
        _, _, v = heapq.heappop(heap)
        w = min(range(warps), key=lambda k: (max(free[k], ready_at[id(v)]), k))
        start = max(free[w], ready_at[id(v)])
        finish[id(v)] = free[w] = start + LATENCY[v.kind] + OVERHEAD
        lists[w].append(v)
        warp_of[id(v)] = w
        popped.append(v)
        for u in users[id(v)]:
            ready_at[id(u)] = max(ready_at[id(u)], finish[id(v)])
            waiting[id(u)] -= 1
            if waiting[id(u)] == 0:
                heapq.heappush(heap, (-prio[id(u)], order[id(u)], u))
    assert len(finish) == len(step_vals)

    # ancestors (as bit sets over the schedule order) of every step value
    rank = {id(v): i for i, v in enumerate(popped)}
    anc: Dict[int, int] = {}
    for v in step_vals:
        a = 0
        for x in v.srcs:
            if id(x) in anc:
                a |= anc[id(x)] | (1 << rank[id(x)])
        anc[id(v)] = a

    # slots: each out value its own out slot (relative id ("out", k)); the
    # other values a temporary, reusing one whose value every reader has
    # read before the new write, for sure: each reader is the writer, an
    # ancestor of it, or an earlier op of its own warp (the reader's flag,
    # or program order, comes first), and a slot takes VERSIONS writes
    out_of = {id(v): k for k, v in enumerate(outs)}
    where: Dict[int, tuple] = {}  # value → (("temp" | "out"), index, version)
    held: List[_Val] = []  # temporary k → the value it holds now
    writes: List[int] = []
    for v in popped:
        if id(v) in fixed:  # a prologue value dblpro computes: its base row
            continue
        if id(v) in out_of:
            where[id(v)] = ("out", out_of[id(v)], 0 if v.kind == SEL else 1)
            continue
        r = rank[id(v)]
        for k, old in enumerate(held):
            readers = users[id(old)]
            if writes[k] < VERSIONS and all(
                    u is v or (anc[id(v)] >> rank[id(u)]) & 1
                    or (rank[id(u)] < r and warp_of[id(u)] == warp_of[id(v)])
                    for u in readers):
                held[k] = v
                writes[k] += 1
                where[id(v)] = ("temp", k, writes[k])
                break
        else:
            held.append(v)
            writes.append(1)
            where[id(v)] = ("temp", len(held) - 1, 1)
    return {"n_acc": n_acc, "first_temp": first_temp, "n_temps": len(held),
            "fixed": fixed, "written": {id(v) for v in written}, "where": where,
            "prologue": prologue_vals, "lists": lists,
            "warp_of": warp_of, "makespan": max(finish.values())}


def _encode(p: dict, warps: int, n_temps: int, sets: str) -> Schedule:
    fixed, where, warp_of = p["fixed"], p["where"], p["warp_of"]
    n = p["n_acc"]
    in0, out0 = (0, n) if sets == "AB" else (n, 0)

    def slot(v, step=True):
        """(row, version, base?): a prologue value has a version only where
        the table itself computes it (dblpro)"""
        if id(v) in fixed:
            k = fixed[id(v)]
            return (in0 + k, 0, 0) if k < n else (k - n, int(step and id(v) in p["written"]), 1)
        rng, k, ver = where[id(v)]
        return (2 * n + k if rng == "temp" else out0 + k), ver, 0

    def enc(v, w=None, step=True):
        """(kind, dst, a, b, c, wait, ver), see ``Schedule``."""
        srcs = [slot(x, step) for x in v.srcs] + [(0, 0, 0)] * (3 - len(v.srcs))
        dst, dver, dbase = slot(v, step)
        wait = sum(1 << k for k, x in enumerate(v.srcs)
                   if step and id(x) in warp_of and warp_of[id(x)] != w)
        wait |= sum(b << (4 + k) for k, (_, _, b) in enumerate(srcs)) | dbase << 7
        ver = sum(sv << (3 * k) for k, (_, sv, _) in enumerate(srcs)) | dver << 9
        return (v.kind, dst, *(r for r, _, _ in srcs), wait, ver)

    return Schedule(warps, n, n_temps, p["first_temp"] - n, sets,
                    tuple(enc(v, step=False) for v in p["prologue"]),
                    tuple(tuple(enc(v, w) for v in ls) for w, ls in enumerate(p["lists"])),
                    p["makespan"])


def _c_ops(ops) -> str:
    rows = []
    for kind, dst, a, b, c, wait, ver in ops:
        rows.append(f"  {{{KIND_NAMES[kind]}, {dst}, {a}, {b}, {c}, 0x{wait:02x}, 0{ver:o}}},")
    return "\n".join(rows)


def _begins(s: Schedule) -> List[int]:
    begins = [0]
    for ls in s.lists:
        begins.append(begins[-1] + len(ls))
    return begins


# the tables of the constant array, in order: (kind, sets)
TABLES = (("step", "AB"), ("step", "BA"), ("dbl", "AB"), ("dbl", "BA"), ("addp", "AB"),
          ("dblpro", "AB"))


def header() -> str:
    """The text of ``csrc/ladder_schedule.h``: per group, every table's
    operations in one constant array (``TABLES``' warps' lists, then the
    prologue), and each warp's range in it."""
    out = [
        "// Generated by `python -m hbbft_tpu_torch.ops.ladder_schedule`; do not edit.",
        "// The step tables of the ladder kernels (see ops/ladder_schedule.py).",
        "",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace hb_sched {",
        "",
        "enum : uint8_t { MUL = 0, ADD = 1, SUB = 2, SEL = 3 };",
        "// the tables, in kG1Range / kG2Range: a kind, the set it reads and the one it writes",
        "enum : int { " + ", ".join(
            f"k{kind.capitalize()}{sets} = {i}" for i, (kind, sets) in enumerate(TABLES))
        + f", kPrologue = {len(TABLES)} }};",
        "",
        "struct __align__(8) Op {",
        "  uint8_t kind, dst, a, b, c;",
        "  uint8_t wait;   // bit k: source k is another warp's value; bit 4 + k: a base row (7: dst)",
        "  uint16_t ver;   // octal digits dst, c, b, a: which write of the slot",
        "};",
    ]
    for group in ("g1", "g2"):
        tables = [build(group, kind, sets) for kind, sets in TABLES]
        s = tables[0]
        g = group.upper()
        lines: List[str] = []
        ranges, n = [], 0
        for (kind, sets), t in zip(TABLES, tables):
            rows = []
            for w, ls in enumerate(t.lists):
                rows.append((n, n + len(ls)))
                n += len(ls)
                lines.append(f"  // {kind} {sets}, warp {w} (a step ~{t.makespan} cycles, "
                             "simulated)")
                lines.append(_c_ops(ls))
            ranges.append(rows)
        lines += ["  // prologue", _c_ops(s.prologue)]
        ranges.append([(n, n + len(s.prologue))] * s.warps)
        total = n + len(s.prologue)
        out += [
            "",
            f"// {g}: {s.warps} warps a row; rows: A 0..{s.n_acc - 1}, B "
            f"{s.n_acc}..{2 * s.n_acc - 1}, temporaries {2 * s.n_acc}..{s.n_slots - 1}; "
            f"a base block of {s.entry_rows} rows",
            f"struct {g} {{",
            f"  static constexpr int kWarps = {s.warps};",
            f"  static constexpr int kAcc = {s.n_acc};",
            f"  static constexpr int kSlots = {s.n_slots};",
            f"  static constexpr int kEntry = {s.entry_rows};  // coordinates, then the prologue's",
            f"  static constexpr int kFlags = {s.n_slots + s.entry_rows - s.n_acc};  "
            "// the slots', then the prologue rows'",
            "};",
            f"__constant__ Op k{g}Ops[{total}] = {{",
            *lines,
            "};",
            f"// [table][warp]: the warp's list, k{g}Ops[begin .. end)",
            f"__constant__ uint16_t k{g}Range[{len(TABLES) + 1}][{s.warps}][2] = {{",
            *("  {" + ", ".join(f"{{{b}, {e}}}" for b, e in rows) + "}," for rows in ranges),
            "};",
        ]
    out += ["", "}  // namespace hb_sched", ""]
    return "\n".join(out)


if __name__ == "__main__":
    with open(HEADER, "w") as fh:
        fh.write(header())
    print(f"wrote {HEADER}")
