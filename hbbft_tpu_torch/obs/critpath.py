"""Per-transaction end-to-end critical path across node/client journals.

The merge/analysis half of the causal tracing layer
(:mod:`hbbft_tpu_torch.obs.trace` is the capture half): read every flight
journal of a run — the nodes' plus any ``ClusterClient(trace_dir=…)``
journals — and answer *where a transaction's latency went*, across
processes, with explicitly-bounded clock uncertainty::

    python -m hbbft_tpu_torch.obs.critpath JOURNAL_DIR... [--json] [--waterfalls N]

**Clock alignment (NTP-style, bound reported — never a point
estimate).**  Each journal's timestamps come from its own process clock.
For every directed pair of processes the matched send/receive pairs —
consensus messages between nodes (paired FIFO per (sender, receiver,
payload digest), like the forensic audit), and the per-tx trace stages
between a client and its node (``submit``→``ingress``, one direction;
``commit``→``commit_seen``, the other) — give one-way delay samples
``t_recv − t_send = delay + θ`` with ``delay > 0``, so the offset
``θ = clock_B − clock_A`` is bounded by the two directions' minima::

    θ ∈ [ −min(B→A samples),  +min(A→B samples) ]

Timestamps are aligned using the interval **midpoint**, and every node's
accumulated interval **width** is reported alongside (``clock_offsets``)
— a decomposition component smaller than the bound is noise, and the
report says so rather than pretending micro-second precision.  Under the
simulator every journal shares the virtual clock, the bounds collapse to
the per-hop cost-model charge, and the whole report is byte-identical
across identical-seed runs.

**Span timebase conversion.**  Runtime span records carry
``perf_counter`` phase times while record stamps are wall clock; the two
are bridged per (node, era, epoch) by the identity
``conv = commit_record.t − epoch_span.t_end`` (both are appended in the
same batch-absorb call, so the pairing error is the append cost, ~µs).

**Decomposition (components sum EXACTLY to the measured total).**  Each
reconstructed tx's milestones are clamped into a monotone chain
``submit → ingress → queued → epoch_start → first_rbc → rbc_end →
aba_end → commit [→ commit_retrieved] → commit_seen`` and consecutive
differences become the components ``wire / pump_queue / mempool_wait /
proposal_wait / rbc / aba / coin / decrypt`` (+ ``retrieve`` for VID
mode's post-ordering payload fetch, + ``other`` for time the journals
could not attribute — counted, never silently spread).  ``coin`` is carved out of
the ABA window (coin spans nest inside ABA rounds); matched inbound
message delays on the committing node are carved out of the rbc/aba/
decrypt windows into ``wire`` — a shaped 100 ms link shows up as wire
time, not as a mysteriously slow protocol phase.

Fault accounting: receives with no matching send, trace stages that
never pair up, and nodes that could not be clock-aligned are all
counted in the report (``unmatched``), never dropped silently.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from bisect import bisect_left, bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.obs.flight import (
    FlightCommit,
    FlightMsg,
    FlightSpan,
    Journal,
    find_journal_dirs,
    read_journal,
    target_covers,
)
from hbbft_tpu_torch.obs.spans import phase_group
from hbbft_tpu_torch.obs.trace import FlightTrace, iter_tids

#: decomposition components, in chain order (``other`` = time the
#: journals could not attribute to a phase — missing spans, torn tails;
#: ``retrieve`` = VID mode's post-ordering payload fetch, the gap
#: between the ``commit`` and ``commit_retrieved`` stages)
COMPONENTS = ("wire", "pump_queue", "mempool_wait", "proposal_wait",
              "rbc", "aba", "coin", "decrypt", "retrieve", "other")


def _digest(payload: bytes) -> str:
    return hashlib.sha3_256(payload).hexdigest()[:16]


def _r(x: float) -> float:
    """Output rounding: 9 decimals (ns) keeps identical-seed runs
    byte-identical across platforms' float formatting."""
    return round(float(x), 9)


# ===========================================================================
# Journal extraction
# ===========================================================================


@dataclass
class _NodeData:
    """One node journal's trace-relevant slices."""

    name: str
    flavor: str
    # tid → earliest (t, detail) per stage
    ingress: Dict[bytes, Tuple[float, str]] = field(default_factory=dict)
    queued: Dict[bytes, float] = field(default_factory=dict)
    # tid → (t, era, epoch) of the commit-stage trace on THIS node
    commit: Dict[bytes, Tuple[float, int, int]] = field(
        default_factory=dict)
    # tid → (t, era, epoch) of the commit_retrieved trace (VID mode:
    # when the lazily-fetched payload resolved on THIS node)
    commit_retrieved: Dict[bytes, Tuple[float, int, int]] = field(
        default_factory=dict)
    # (era, epoch) → earliest FlightCommit record t
    commit_rec_t: Dict[Tuple[int, int], float] = field(
        default_factory=dict)
    # (era, epoch) → list of FlightSpan
    spans: Dict[Tuple[int, int], List[FlightSpan]] = field(
        default_factory=dict)
    # messages for offset estimation / wire carve-out
    msgs_in: List[FlightMsg] = field(default_factory=list)
    msgs_out: List[FlightMsg] = field(default_factory=list)


@dataclass
class _ClientData:
    """One client journal's per-tx stages."""

    name: str
    submit: Dict[bytes, float] = field(default_factory=dict)
    ack: Dict[bytes, float] = field(default_factory=dict)
    # tid → (t, era, epoch)
    commit_seen: Dict[bytes, Tuple[float, int, int]] = field(
        default_factory=dict)


def _extract(journals: Sequence[Journal]
             ) -> Tuple[Dict[str, _NodeData], Dict[str, _ClientData]]:
    nodes: Dict[str, _NodeData] = {}
    clients: Dict[str, _ClientData] = {}
    for j in journals:
        if j.flavor == "client":
            c = clients.setdefault(j.node, _ClientData(j.node))
            for _inc, rec in j.records:
                if not isinstance(rec, FlightTrace):
                    continue
                for tid in iter_tids(rec.tids):
                    if rec.stage == "submit":
                        if tid not in c.submit:
                            c.submit[tid] = rec.t
                    elif rec.stage == "ack":
                        if tid not in c.ack:
                            c.ack[tid] = rec.t
                    elif rec.stage == "commit_seen":
                        if tid not in c.commit_seen:
                            c.commit_seen[tid] = (rec.t, rec.era,
                                                  rec.epoch)
            continue
        nd = nodes.setdefault(j.node, _NodeData(j.node, j.flavor))
        for _inc, rec in j.records:
            if isinstance(rec, FlightTrace):
                for tid in iter_tids(rec.tids):
                    if rec.stage == "ingress":
                        if tid not in nd.ingress:
                            nd.ingress[tid] = (rec.t, rec.detail)
                    elif rec.stage == "queued":
                        if tid not in nd.queued:
                            nd.queued[tid] = rec.t
                    elif rec.stage == "commit":
                        if tid not in nd.commit:
                            nd.commit[tid] = (rec.t, rec.era, rec.epoch)
                    elif rec.stage == "commit_retrieved":
                        if tid not in nd.commit_retrieved:
                            nd.commit_retrieved[tid] = (rec.t, rec.era,
                                                        rec.epoch)
            elif isinstance(rec, FlightCommit):
                key = (rec.era, rec.epoch)
                if key not in nd.commit_rec_t:
                    nd.commit_rec_t[key] = rec.t
            elif isinstance(rec, FlightSpan):
                nd.spans.setdefault((rec.era, rec.epoch), []).append(rec)
            elif isinstance(rec, FlightMsg):
                if rec.direction == "in":
                    nd.msgs_in.append(rec)
                else:
                    nd.msgs_out.append(rec)
    return nodes, clients


# ===========================================================================
# Clock offsets: pairwise one-way-delay minima → bounded offsets
# ===========================================================================


@dataclass
class _Alignment:
    #: process name → clock offset vs the anchor (midpoint estimate)
    offset: Dict[str, float]
    #: process name → accumulated offset-interval width along the
    #: alignment path (the BOUND: components below this are noise)
    bound: Dict[str, float]
    anchor: str
    edges: List[Dict[str, Any]]
    unmatched_receives: int
    unaligned: List[str]


def _collect_delay_minima(nodes: Dict[str, _NodeData],
                          clients: Dict[str, _ClientData],
                          ) -> Tuple[Dict[Tuple[str, str], Tuple[float,
                                                                 int]],
                                     int,
                                     Dict[str, List[Tuple[float, float]]]]:
    """min one-way delay sample per directed (sender, receiver) pair,
    the unmatched-receive count, and per-receiver matched (t_recv,
    delay_sample) lists for the wire carve-out (delay samples still
    carry the pair's clock offset here; the carve-out corrects them
    once offsets are known)."""
    # FIFO pairing per (sender, receiver, payload digest), like the audit
    outs: Dict[Tuple[str, str, str], List[float]] = defaultdict(list)
    ins: Dict[Tuple[str, str, str], List[float]] = defaultdict(list)
    node_names = sorted(nodes)
    for name in node_names:
        nd = nodes[name]
        for rec in nd.msgs_out:
            if not rec.payload:
                continue
            d = _digest(rec.payload)
            for other in node_names:
                if other != name and target_covers(rec.peer, other):
                    outs[(name, other, d)].append(rec.t)
        for rec in nd.msgs_in:
            if not rec.payload:
                continue
            ins[(rec.peer, name, _digest(rec.payload))].append(rec.t)
    minima: Dict[Tuple[str, str], Tuple[float, int]] = {}
    recv_delays: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    unmatched = 0

    def feed(a: str, b: str, sample: float, t_recv: float) -> None:
        cur = minima.get((a, b))
        minima[(a, b)] = (sample if cur is None else min(cur[0], sample),
                          1 if cur is None else cur[1] + 1)
        recv_delays[b].append((t_recv, sample))

    for key in sorted(ins):
        sender, receiver, _d = key
        in_ts = sorted(ins[key])
        out_ts = sorted(outs.get(key, ()))
        k = min(len(in_ts), len(out_ts))
        for i in range(k):
            feed(sender, receiver, in_ts[i] - out_ts[i], in_ts[i])
        unmatched += len(in_ts) - k
    # client↔node edges from the per-tx trace stages
    for cname in sorted(clients):
        c = clients[cname]
        for name in node_names:
            nd = nodes[name]
            for tid in sorted(c.submit):
                hit = nd.ingress.get(tid)
                if hit is not None:
                    feed(cname, name, hit[0] - c.submit[tid], hit[0])
            for tid in sorted(c.commit_seen):
                hit = nd.commit.get(tid)
                if hit is not None:
                    t_seen = c.commit_seen[tid][0]
                    feed(name, cname, t_seen - hit[0], t_seen)
    return minima, unmatched, recv_delays


def _align(nodes: Dict[str, _NodeData],
           clients: Dict[str, _ClientData],
           ) -> Tuple[_Alignment, Dict[str, List[Tuple[float, float]]]]:
    minima, unmatched, recv_delays = _collect_delay_minima(nodes, clients)
    names = sorted(nodes) + sorted(clients)
    # undirected edges where BOTH directions produced samples: the
    # offset interval is [-min_ba, +min_ab]
    edges: Dict[Tuple[str, str], Tuple[float, float, int]] = {}
    for (a, b), (d_ab, n_ab) in sorted(minima.items()):
        if a > b:
            continue
        back = minima.get((b, a))
        if back is None:
            continue
        d_ba, n_ba = back
        # θ = clock_b − clock_a ∈ [−d_ba, +d_ab]
        edges[(a, b)] = ((d_ab - d_ba) / 2.0, d_ab + d_ba, n_ab + n_ba)
    anchor = sorted(nodes)[0] if nodes else (names[0] if names else "")
    offset: Dict[str, float] = {anchor: 0.0} if anchor else {}
    bound: Dict[str, float] = {anchor: 0.0} if anchor else {}
    # BFS from the anchor over bounded edges, accumulating widths;
    # visit order is sorted for determinism
    frontier = [anchor] if anchor else []
    while frontier:
        nxt: List[str] = []
        for cur in frontier:
            for (a, b), (mid, width, _n) in sorted(edges.items()):
                if a == cur and b not in offset:
                    offset[b] = offset[a] + mid
                    bound[b] = bound[a] + width
                    nxt.append(b)
                elif b == cur and a not in offset:
                    offset[a] = offset[b] - mid
                    bound[a] = bound[b] + width
                    nxt.append(a)
        frontier = sorted(nxt)
    unaligned = [n for n in names if n not in offset]
    for n in unaligned:
        # counted above; aligning at 0 keeps the tx chain monotone-
        # clampable instead of discarding every tx touching the process
        offset[n] = 0.0
        bound[n] = float("inf")
    edge_docs = [
        {"a": a, "b": b, "offset_s": _r(mid), "bound_s": _r(width),
         "samples": n}
        for (a, b), (mid, width, n) in sorted(edges.items())
    ]
    align = _Alignment(offset=offset, bound=bound, anchor=anchor,
                       edges=edge_docs, unmatched_receives=unmatched,
                       unaligned=unaligned)
    # wire carve-out index: matched inbound (t_recv, delay) per node,
    # aligned to the anchor clock and offset-corrected, sorted by time
    carve: Dict[str, List[Tuple[float, float]]] = {}
    for name, samples in sorted(recv_delays.items()):
        if name not in nodes:
            continue
        off = offset[name]
        fixed = []
        for t_recv, raw in samples:
            # raw = true_delay + θ(sender→receiver path); correcting by
            # the estimated pairwise offset leaves delay ± the bound
            fixed.append((t_recv - off, max(0.0, raw)))
        fixed.sort()
        carve[name] = fixed
    return align, carve


# ===========================================================================
# Per-epoch phase windows (span timebase converted, clock aligned)
# ===========================================================================


@dataclass
class _EpochPhases:
    epoch_start: float
    first_rbc: float
    rbc_end: float
    aba_end: float
    decrypt_end: float
    coin_s: float


def _epoch_phases(nd: _NodeData, key: Tuple[int, int],
                  node_offset: float) -> Optional[_EpochPhases]:
    spans = nd.spans.get(key)
    commit_t = nd.commit_rec_t.get(key)
    if not spans or commit_t is None:
        return None
    epoch_span = next((s for s in spans if s.name == "epoch"), None)
    if epoch_span is None:
        return None
    # span clock → record clock: both the epoch span and the commit
    # record are appended in the same batch-absorb call
    conv = (commit_t - epoch_span.t_end) - node_offset
    by_group: Dict[str, List[FlightSpan]] = defaultdict(list)
    for s in spans:
        by_group[phase_group(s.name)].append(s)
    t0 = epoch_span.t_start + conv
    rbc = by_group.get("rbc", ())
    aba = by_group.get("aba", ())
    coin = by_group.get("coin", ())
    dec = by_group.get("decrypt", ())
    first_rbc = (min(s.t_start for s in rbc) + conv) if rbc else t0
    rbc_end = (max(s.t_end for s in rbc) + conv) if rbc else first_rbc
    aba_like = list(aba) + list(coin)
    aba_end = (max(s.t_end for s in aba_like) + conv) if aba_like \
        else rbc_end
    decrypt_end = (max(s.t_end for s in dec) + conv) if dec else aba_end
    coin_s = sum(s.t_end - s.t_start for s in coin)
    return _EpochPhases(epoch_start=t0, first_rbc=first_rbc,
                        rbc_end=rbc_end, aba_end=aba_end,
                        decrypt_end=decrypt_end, coin_s=coin_s)


def _wire_in_window(carve: List[Tuple[float, float]], a: float,
                    b: float) -> float:
    """Max matched inbound one-way delay arriving in [a, b), capped at
    the window length — the wire share of a phase window (the phase was
    waiting on that arrival; anything beyond the window length belongs
    to an earlier window)."""
    if b <= a or not carve:
        return 0.0
    lo = bisect_left(carve, (a, -1.0))
    hi = bisect_right(carve, (b, -1.0))
    best = 0.0
    for i in range(lo, hi):
        if carve[i][1] > best:
            best = carve[i][1]
    return min(best, b - a)


# ===========================================================================
# Per-tx assembly
# ===========================================================================


def _assemble(nodes: Dict[str, _NodeData],
              clients: Dict[str, _ClientData],
              align: _Alignment,
              carve: Dict[str, List[Tuple[float, float]]],
              ) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
    """One waterfall dict per reconstructable tx + the miss counters."""
    off = align.offset
    misses = {"no_ingress": 0, "no_queued": 0, "no_commit": 0,
              "no_commit_seen": 0}
    # which client submitted each tid (earliest submit wins)
    submitter: Dict[bytes, str] = {}
    for cname in sorted(clients):
        for tid, t in clients[cname].submit.items():
            cur = submitter.get(tid)
            if cur is None or t - off[cname] < (
                    clients[cur].submit[tid] - off[cur]):
                submitter[tid] = cname
    # every committed tid, from every node's commit-stage traces
    committed: Dict[bytes, Tuple[str, float, int, int]] = {}
    for name in sorted(nodes):
        for tid, (t, era, epoch) in nodes[name].commit.items():
            t_al = t - off[name]
            cur = committed.get(tid)
            if cur is None or t_al < cur[1]:
                committed[tid] = (name, t_al, era, epoch)
    phase_cache: Dict[Tuple[str, int, int], Optional[_EpochPhases]] = {}
    rows: List[Dict[str, Any]] = []
    for tid in sorted(committed):
        # the tx's home node: where it ingressed (falls back to the
        # earliest committer for foreign/unseen ingress)
        home = None
        for name in sorted(nodes):
            if tid in nodes[name].ingress:
                home = name
                break
        if home is None:
            misses["no_ingress"] += 1
            continue
        nd = nodes[home]
        h_off = off[home]
        t_ingress = nd.ingress[tid][0] - h_off
        commit_here = nd.commit.get(tid)
        if commit_here is None:
            misses["no_commit"] += 1
            continue
        t_commit = commit_here[0] - h_off
        era, epoch = commit_here[1], commit_here[2]
        # VID mode: when the lazily-retrieved payload became readable on
        # the home node (== t_commit for locally-dispersed payloads,
        # absent entirely in classic-RBC mode)
        retrieved_here = nd.commit_retrieved.get(tid)
        t_retrieved = (retrieved_here[0] - h_off
                       if retrieved_here is not None else None)
        t_queued = nd.queued.get(tid)
        if t_queued is not None:
            t_queued -= h_off
        cname = submitter.get(tid)
        t_submit = t_ack = t_seen = None
        if cname is not None:
            c = clients[cname]
            t_submit = c.submit[tid] - off[cname]
            if tid in c.ack:
                t_ack = c.ack[tid] - off[cname]
            seen = c.commit_seen.get(tid)
            if seen is not None:
                t_seen = seen[0] - off[cname]
            else:
                misses["no_commit_seen"] += 1
        ckey = (home, era, epoch)
        ph = phase_cache.get(ckey)
        if ckey not in phase_cache:
            ph = _epoch_phases(nd, (era, epoch), h_off)
            phase_cache[ckey] = ph
        comp = {k: 0.0 for k in COMPONENTS}
        start = t_submit if t_submit is not None else t_ingress
        cur = start

        def take(name: str, t: Optional[float]) -> None:
            nonlocal cur
            if t is None:
                return
            t = max(t, cur)
            comp[name] += t - cur
            cur = t

        take("wire", t_ingress)
        if t_queued is None and nd.flavor == "runtime":
            misses["no_queued"] += 1
        take("pump_queue", t_queued)
        if ph is not None:
            seg0 = cur
            take("mempool_wait", ph.epoch_start)
            take("proposal_wait", ph.first_rbc)
            rbc_a = cur
            take("rbc", ph.rbc_end)
            aba_a = cur
            take("aba", ph.aba_end)
            dec_a = cur
            take("decrypt", max(ph.decrypt_end, t_commit))
            take("other", t_commit)
            # coin is a carve-out of the ABA window (coin spans nest
            # inside ABA rounds)
            coin = min(comp["aba"], ph.coin_s)
            comp["aba"] -= coin
            comp["coin"] += coin
            # wire carve-out: matched inbound delays landing inside a
            # phase window were network wait, not protocol work —
            # a shaped link must surface as wire time
            cv = carve.get(home, [])
            for g, (a, b) in (("rbc", (rbc_a, aba_a)),
                              ("aba", (aba_a, dec_a)),
                              ("decrypt", (dec_a, cur))):
                w = min(_wire_in_window(cv, a, b), comp[g])
                comp[g] -= w
                comp["wire"] += w
            del seg0
        else:
            take("other", t_commit)
        # post-ordering retrieval (VID): commit → commit_retrieved — by
        # construction the pre-retrieve components sum exactly to
        # submit→commit, and adding ``retrieve`` extends the identity to
        # submit→commit_retrieved
        take("retrieve", t_retrieved)
        take("wire", t_seen)
        total = cur - start
        row = {
            "tid": tid.hex(),
            "node": home,
            "client": cname,
            "era": era,
            "epoch": epoch,
            "t_submit": _r(t_submit) if t_submit is not None else None,
            "t_ingress": _r(t_ingress),
            "t_commit": _r(t_commit),
            "t_commit_retrieved": (_r(t_retrieved)
                                   if t_retrieved is not None else None),
            "t_commit_seen": _r(t_seen) if t_seen is not None else None,
            "t_ack": _r(t_ack) if t_ack is not None else None,
            "total_s": _r(total),
            "components": {k: _r(v) for k, v in comp.items()},
        }
        rows.append(row)
    return rows, misses


# ===========================================================================
# Aggregation + report
# ===========================================================================


def _percentile_row(rows: List[Dict[str, Any]], q: float
                    ) -> Dict[str, Any]:
    """Nearest-rank percentile BY TOTAL, reporting that tx's own
    decomposition — so the components sum to exactly the percentile
    latency shown (an average of decompositions would not)."""
    ordered = sorted(rows, key=lambda r: (r["total_s"], r["tid"]))
    idx = max(0, min(len(ordered) - 1,
                     int(round(q / 100.0 * len(ordered) + 0.5)) - 1))
    row = ordered[idx]
    comps = row["components"]
    dominant = max(sorted(comps), key=lambda k: comps[k])
    return {
        "total_s": row["total_s"],
        "components": comps,
        "dominant": dominant,
        "dominant_s": comps[dominant],
        "tid": row["tid"],
        "node": row["node"],
    }


def build_report(paths: Sequence[str], waterfalls: int = 5
                 ) -> Dict[str, Any]:
    """The full critical-path report over one run's journal dirs."""
    journals = [read_journal(d) for d in paths]
    nodes, clients = _extract(journals)
    align, carve = _align(nodes, clients)
    rows, misses = _assemble(nodes, clients, align, carve)
    committed_tids = set()
    for nd in nodes.values():
        committed_tids.update(nd.commit)
    n_committed = len(committed_tids)
    mean = {k: 0.0 for k in COMPONENTS}
    for row in rows:
        for k in COMPONENTS:
            mean[k] += row["components"][k]
    if rows:
        mean = {k: _r(v / len(rows)) for k, v in mean.items()}
    report: Dict[str, Any] = {
        "journals": len(journals),
        "nodes": sorted(nodes),
        "clients": sorted(clients),
        "anchor": align.anchor,
        "clock_offsets": {
            n: {"offset_s": _r(align.offset[n]),
                "bound_s": (_r(align.bound[n])
                            if align.bound[n] != float("inf") else None)}
            for n in sorted(align.offset)
        },
        "clock_edges": align.edges,
        "txs_committed": n_committed,
        "txs_reconstructed": len(rows),
        "reconstructed_fraction": (
            _r(len(rows) / n_committed) if n_committed else 0.0),
        "unmatched": dict(sorted(misses.items()), **{
            "receives": align.unmatched_receives,
            "unaligned_processes": align.unaligned,
        }),
        "mean_components": mean,
    }
    if rows:
        report["p50"] = _percentile_row(rows, 50.0)
        report["p99"] = _percentile_row(rows, 99.0)
    # waterfalls: the slowest txs first — where the long tail lives
    slowest = sorted(rows, key=lambda r: (-r["total_s"], r["tid"]))
    report["waterfalls"] = slowest[:max(0, waterfalls)]
    return report


def render(report: Dict[str, Any]) -> str:
    """Human-readable report (the default CLI output)."""
    lines = [
        f"critpath: {report['journals']} journals — "
        f"{len(report['nodes'])} nodes, {len(report['clients'])} clients",
        f"txs committed={report['txs_committed']} "
        f"reconstructed={report['txs_reconstructed']} "
        f"({report['reconstructed_fraction'] * 100:.1f}%)",
    ]
    for n in report["nodes"] + report["clients"]:
        doc = report["clock_offsets"].get(n, {})
        b = doc.get("bound_s")
        lines.append(
            f"  clock {n}: offset {doc.get('offset_s', 0.0) * 1e3:.3f} ms"
            + (f" ± {b * 1e3 / 2:.3f} ms" if b is not None
               else " (UNALIGNED)"))
    for p in ("p50", "p99"):
        doc = report.get(p)
        if doc is None:
            continue
        comps = " ".join(
            f"{k}={doc['components'][k] * 1e3:.2f}ms"
            for k in COMPONENTS if doc["components"][k] > 0)
        lines.append(f"{p}: {doc['total_s'] * 1e3:.2f} ms "
                     f"[dominant: {doc['dominant']} "
                     f"{doc['dominant_s'] * 1e3:.2f} ms] {comps}")
    um = report["unmatched"]
    lines.append(
        "unmatched: " + " ".join(f"{k}={um[k]}" for k in sorted(um)
                                 if k != "unaligned_processes"))
    for row in report["waterfalls"]:
        comps = " ".join(
            f"{k}={row['components'][k] * 1e3:.2f}"
            for k in COMPONENTS if row["components"][k] > 0)
        lines.append(
            f"  tx {row['tid'][:8]} ({row['node']} e{row['era']}/"
            f"{row['epoch']}): {row['total_s'] * 1e3:.2f} ms  {comps}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hbbft_tpu_torch.obs.critpath",
        description="per-transaction end-to-end critical path across "
                    "node/client flight journals")
    ap.add_argument("paths", nargs="+",
                    help="journal dirs (or roots holding node-N/ dirs)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as deterministic JSON")
    ap.add_argument("--waterfalls", type=int, default=5,
                    help="per-tx waterfalls to include (slowest first)")
    args = ap.parse_args(argv)
    dirs: List[str] = []
    for p in args.paths:
        dirs.extend(find_journal_dirs(p))
    if not dirs:
        print(f"no journal segments under {args.paths!r}",
              file=sys.stderr)
        return 2
    report = build_report(sorted(dirs), waterfalls=args.waterfalls)
    if args.json:
        print(json.dumps(report, sort_keys=True, indent=1))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via -m
    sys.exit(main())
