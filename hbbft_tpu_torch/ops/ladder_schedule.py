"""The whole-ladder kernel's step schedule: one table for the kernel and its
lane model.

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

In the kernel (``csrc/ladder_lazy.cu``) every value of a step has its own
shared-memory slot (one 13-bit digit a lane) and a ready flag; a warp waits
for the flag of each operand that another warp computes (its own are ready
by program order), computes, stores and raises its destination's flag;
the step ends at a block barrier.  An operation waits only for operations
that started earlier in the simulated schedule, so no warp order can
deadlock.  ``SEL`` writes the next accumulator:
``acc = bit ? (inf ? base : (base_inf ? d : s)) : d``.

The windowed kernel (``csrc/ladder_window.cu``) runs the same step table
and two more over the same slot layout, both without selects: ``dbl``
(``point_double`` of the accumulator alone) and ``addp`` (``point_add_raw``
of the accumulator and the base point, for the table's odd entries).  Their
results stay in temporaries (``outs``), which the kernel copies after a
barrier, to the accumulator or to a table entry.  A table entry holds what
the base block holds — the coordinates and the prologue's values — so
before a window's step the kernel copies the selected entry into the base
block and the step table runs unchanged.

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
# and the simulated start times only: a product about twice a sum, as the
# card shows (PERF.md); the simulated step is shorter than the card's,
# which also waits on flags and shares each SM's int32 pipe.
LATENCY = {MUL: 1400, ADD: 660, SUB: 660, SEL: 120}
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


KINDS = ("step", "dbl", "addp")  # the tables, see the module docstring


@dataclass(frozen=True)
class Schedule:
    """One group's table of one kind.  Slots: ``acc`` then ``base`` (3 or 6
    each, in (x, y, z) × (re, im) order), then prologue results (the base
    block ends at ``first_temp``, the same for every kind), then the
    table's temporaries.  An op is ``(kind, dst, a, b, c, wait)`` (``c``
    only for SEL; ``wait``: which sources another warp computes in this
    step).  ``outs``: the temporaries that hold the result of a table
    without selects (empty for ``step``, whose selects write ``acc``)."""

    warps: int
    n_acc: int
    first_temp: int
    n_slots: int
    prologue: Tuple[tuple, ...]
    lists: Tuple[Tuple[tuple, ...], ...]  # one ordered op list per warp
    makespan: int  # simulated cycles of one step
    outs: Tuple[int, ...] = ()


def _flat(p, fp2):
    return [e for c in p for e in (c if fp2 else (c,))]


def build(group: str, kind: str = "step") -> Schedule:
    """Trace, hoist, schedule and assign slots for ``group`` ("g1"/"g2")
    and table ``kind`` (one of ``KINDS``) on its ``WARPS[group]`` warps a
    row."""
    return _schedule(group, WARPS[group], kind)


def _live(t, outs):
    """The traced ops that reach ``outs``, in trace order."""
    live, stack = set(), list(outs)
    while stack:
        v = stack.pop()
        if id(v) not in live:
            live.add(id(v))
            stack.extend(v.srcs)
    return [v for v in t.ops if id(v) in live]


def _schedule(group: str, warps: int, kind: str = "step") -> Schedule:
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
    elif kind == "dbl":
        outs = _flat(d, fp2)
    else:
        outs = _flat(G.point_add_raw(o, acc, base), fp2)
    ops = _live(t, outs)
    assert all(id(v) in {id(p) for p in prologue_vals} for v in ops if v.const)
    step_vals = [v for v in ops if not v.const]

    inputs = _flat(acc, fp2) + _flat(base, fp2)
    n_acc = len(inputs) // 2
    temps = [v for v in step_vals if v.kind != SEL]
    first_temp = len(inputs) + len(prologue_vals)
    n_slots = first_temp + len(temps)
    assert n_slots <= 256, "slot ids are bytes"
    slot = {id(v): i for i, v in enumerate(inputs + prologue_vals + temps)}
    if kind == "step":
        slot.update({id(v): i for i, v in enumerate(outs)})  # the selects write acc

    warp_of: Dict[int, int] = {}

    def enc(v, w=None):
        """(kind, dst, a, b, c, wait): bit k of wait marks source k as a
        value of this step that another warp computes (the kernel waits on
        its flag; one of this warp's own is ready by program order)."""
        srcs = [slot[id(x)] for x in v.srcs] + [0] * (3 - len(v.srcs))
        wait = sum(1 << k for k, x in enumerate(v.srcs)
                   if id(x) in warp_of and warp_of[id(x)] != w)
        return (v.kind, slot[id(v)], *srcs, wait)

    # list schedule: longest path to the selects first
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
    lists: List[List[tuple]] = [[] for _ in range(warps)]
    finish: Dict[int, int] = {}
    while heap:
        _, _, v = heapq.heappop(heap)
        w = min(range(warps), key=lambda k: (max(free[k], ready_at[id(v)]), k))
        start = max(free[w], ready_at[id(v)])
        finish[id(v)] = free[w] = start + LATENCY[v.kind] + OVERHEAD
        lists[w].append(enc(v, w))
        warp_of[id(v)] = w
        for u in users[id(v)]:
            ready_at[id(u)] = max(ready_at[id(u)], finish[id(v)])
            waiting[id(u)] -= 1
            if waiting[id(u)] == 0:
                heapq.heappush(heap, (-prio[id(u)], order[id(u)], u))
    assert len(finish) == len(step_vals)

    # A select overwrites an accumulator slot in place: every reader of that
    # slot must be one of its ancestors, so it has read before the write.
    anc: Dict[int, set] = {}
    for v in step_vals:
        a = set()
        for x in v.srcs:
            if id(x) in anc:
                a |= anc[id(x)] | {id(x)}
        anc[id(v)] = a
    for v in sels if kind == "step" else ():
        readers = [u for u in step_vals if any(slot[id(x)] == slot[id(v)] and x in inputs
                                               for x in u.srcs)]
        assert all(id(u) in anc[id(v)] for u in readers), "select overwrites a live slot"

    return Schedule(warps, n_acc, first_temp, n_slots,
                    tuple(enc(v) for v in prologue_vals),
                    tuple(tuple(ls) for ls in lists), max(finish.values()),
                    () if kind == "step" else tuple(slot[id(v)] for v in outs))


def _c_ops(ops) -> str:
    rows = []
    for kind, dst, a, b, c, wait in ops:
        rows.append(f"  {{{KIND_NAMES[kind]}, {dst}, {a}, {b}, {c}, {wait}}},")
    return "\n".join(rows)


def _begins(s: Schedule) -> List[int]:
    begins = [0]
    for ls in s.lists:
        begins.append(begins[-1] + len(ls))
    return begins


def _c_table(name: str, s: Schedule) -> List[str]:
    """``<name>Ops`` (every warp's list, one after another) and
    ``<name>Begin`` (where each warp's list starts)."""
    begins = _begins(s)
    return [
        f"__constant__ Op {name}Ops[{begins[-1]}] = {{",
        "\n".join(f"  // warp {w}\n" + _c_ops(ls) for w, ls in enumerate(s.lists)),
        "};",
        f"__constant__ int {name}Begin[{s.warps + 1}] = {{{', '.join(map(str, begins))}}};",
    ]


def header() -> str:
    """The text of ``csrc/ladder_schedule.h``."""
    out = [
        "// Generated by `python -m hbbft_tpu_torch.ops.ladder_schedule`; do not edit.",
        "// The step tables of the whole-ladder kernel (see ops/ladder_schedule.py).",
        "",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace hb_sched {",
        "",
        "enum : uint8_t { MUL = 0, ADD = 1, SUB = 2, SEL = 3 };",
        "",
        "struct __align__(8) Op {",
        "  uint8_t kind, dst, a, b, c;",
        "  uint8_t wait;  // bit k: source k is another warp's value of this step",
        "};",
    ]
    for group in ("g1", "g2"):
        s = build(group)
        win = {k: build(group, k) for k in KINDS[1:]}
        g = group.upper()
        begins = _begins(s)
        out += [
            "",
            f"// {g}: {s.warps} warps a row, {s.n_slots} slots, "
            f"{len(s.prologue)} prologue and {begins[-1]} step operations, "
            f"~{s.makespan} cycles a step (simulated)",
            f"struct {g} {{",
            f"  static constexpr int kWarps = {s.warps};",
            f"  static constexpr int kAcc = {s.n_acc};",
            f"  static constexpr int kFirstTemp = {s.first_temp};",
            f"  static constexpr int kSlots = {s.n_slots};",
            f"  static constexpr int kPrologue = {len(s.prologue)};",
            f"  static constexpr int kOps = {begins[-1]};",
            "  // the windowed kernel's: slots of its three tables, ops of the others",
            f"  static constexpr int kWinSlots = "
            f"{max([s.n_slots] + [w.n_slots for w in win.values()])};",
            f"  static constexpr int kDblOps = {_begins(win['dbl'])[-1]};",
            f"  static constexpr int kAddpOps = {_begins(win['addp'])[-1]};",
            "};",
            f"__constant__ Op k{g}Prologue[{max(len(s.prologue), 1)}] = {{",
            _c_ops(s.prologue) if s.prologue else "  {0, 0, 0, 0, 0, 0},",
            "};",
        ]
        out += _c_table(f"k{g}", s)
        for kind, w in win.items():
            name = f"k{g}{kind.capitalize()}"
            out += [
                "",
                f"// {g} {kind}: {w.n_slots} slots, {_begins(w)[-1]} operations, "
                f"~{w.makespan} cycles (simulated); the result in slots `{name}Out`",
            ]
            out += _c_table(name, w)
            out.append(f"__constant__ uint8_t {name}Out[{w.n_acc}] = "
                       f"{{{', '.join(map(str, w.outs))}}};")
    out += ["", "}  // namespace hb_sched", ""]
    return "\n".join(out)


if __name__ == "__main__":
    with open(HEADER, "w") as fh:
        fh.write(header())
    print(f"wrote {HEADER}")
