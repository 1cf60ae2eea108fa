"""Cross-node forensic audit of flight-recorder journals.

``python -m hbbft_tpu_torch.obs.audit DIR [DIR ...]`` merges the per-node
journals written by :mod:`hbbft_tpu_torch.obs.flight` (each ``DIR`` is one
node's journal directory, or a parent holding ``node-*/`` journal
directories) and answers the operator questions a live ``/metrics``
scrape cannot:

- **causal cluster timeline** — every journaled event of every node,
  merged into one deterministic order (era, epoch, then a canonical
  event key), with sends matched to their receives by payload digest +
  target coverage.  Two audits of journals from the same deterministic
  run produce byte-identical timelines (``--timeline``);
- **agreement invariants** — all nodes' ledger-digest chains must agree
  wherever they overlap (including a node's own chain across restarts:
  replay/catch-up must rebuild the *identical* prefix), and committed
  (era, epoch) keys must be strictly monotone per node incarnation.  On
  a fork the report names the **first divergent epoch** and prints the
  surrounding event window instead of a wall of hashes;
- **equivocation evidence** — conflicting protocol messages from one
  sender for the same slot (two Merkle roots for one RBC instance, two
  Conf values for one ABA round, two decryption shares for one
  ciphertext…), reconstructed from the *receivers'* journals and keyed
  to the matching :class:`~hbbft_tpu_torch.fault_log.FaultKind` variant, with
  the first affected epoch — the slashing-grade artifact.

Verdict: ``clean`` (all invariants hold), ``fork`` (digest chains
disagree), or ``fault`` (equivocation / monotonicity evidence, chains
intact).  Exit status 0 only on ``clean``.  Torn journal tails (crash
mid-record) are skipped loudly and counted, never fatal.

``--status HOST:PORT`` cross-checks a live node's ``/status`` chain head
+ length against its journal without needing the full chain.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.obs.audit_stream import (  # noqa: F401 — re-exported API
    _OVERLOAD_FAULT_KINDS,
    _RANK,
    _digest,
    _is_restart_reproposal,
    _parse_guard_note,
    _parse_statesync_note,
    _parse_vid_note,
    AuditResult,
    Event,
    IncrementalAuditor,
    equivocation_key,
)
from hbbft_tpu_torch.obs.flight import (
    Journal,
    find_journal_dirs,
    read_journal,
)


# ===========================================================================
# Audit
# ===========================================================================


def audit(journals: List[Journal]) -> AuditResult:
    """Merge journals, build the timeline, verify every invariant.

    Thin batch wrapper over the incremental core: every record of every
    journal is fed to an :class:`~hbbft_tpu_torch.obs.audit_stream.
    IncrementalAuditor` in journal order and the verdict is derived
    once — byte-identical to the historical single-pass implementation
    (regression-tested against the CLI output in test_obs_audit)."""
    aud = IncrementalAuditor()
    for j in journals:
        aud.add_node(j.node)
        for inc in j.incarnations:
            aud.observe_incarnation(j.node, inc)
        aud.add_torn(j.torn_tails)
        for inc, rec in j.records:
            aud.feed(j.node, inc, rec)
    return aud.result()


def cross_check_status(res: AuditResult, doc: Dict[str, Any]) -> None:
    """Compare a live node's ``/status`` chain head + length against its
    journal (satellite of the bounded-digest-chain work: the auditor can
    sanity-check a running node without pulling its full journal)."""
    node = doc.get("node")
    chain = res.chains.get(node)
    if chain is None:
        res.status_mismatches.append(
            f"{node}: no journaled commits to cross-check")
        return
    live_len = doc.get("chain_len", doc.get("batches", 0))
    tail = doc.get("digest_chain", [])
    offset = doc.get("digest_chain_offset", 0)
    overlap = [i for i in range(offset, offset + len(tail))
               if i in chain["commits"]]
    if not overlap:
        res.status_mismatches.append(
            f"{node}: journal (len {chain['len']}) and live chain "
            f"(len {live_len}) do not overlap")
        return
    for i in overlap:
        if chain["commits"][i][0] != tail[i - offset]:
            res.status_mismatches.append(
                f"{node}: journal digest at index {i} != live "
                f"/status digest ({chain['commits'][i][0][:16]} vs "
                f"{tail[i - offset][:16]})")
            return


# ===========================================================================
# Report
# ===========================================================================


def format_report(res: AuditResult, timeline: bool = False,
                  window: int = 4) -> str:
    lines: List[str] = []
    lines.append(f"flight audit: {len(res.nodes)} journals, "
                 f"{len(res.events)} events, "
                 f"{res.torn_tails} torn tails")
    for node in res.nodes:
        chain = res.chains.get(node)
        head = f"len={chain['len']} head={chain['head'][:16]}" \
            if chain else "no commits"
        lines.append(f"  node {node}: restarts={res.restarts[node]} "
                     f"{head}")
    if timeline:
        lines.append("-- timeline --")
        lines.extend(e.line for e in res.events)
    if res.first_divergence:
        d = res.first_divergence
        lines.append(f"FORK: first divergent epoch era={d['era']} "
                     f"epoch={d['epoch']} (chain index {d['index']})")
        for n, v in d["per_node"].items():
            lines.append(f"  {n}: era={v['era']} epoch={v['epoch']} "
                         f"digest={v['digest']}")
        lines.append("-- event window around divergence --")
        era, epoch = d["era"], d["epoch"]
        for e in res.events:
            if e.era == era and abs(e.epoch - epoch) <= window:
                lines.append("  " + e.line)
    for c in res.self_conflicts:
        lines.append(f"SELF-FORK: {c['node']} rebuilt index "
                     f"{c['index']} differently: {c['digests']}")
    for v in res.monotonicity_violations:
        lines.append(f"NON-MONOTONE: {v['node']}#{v['incarnation']} "
                     f"committed {v['next']} after {v['prev']}")
    for e in res.equivocations:
        wit = "; ".join(f"{d}<-{','.join(w)}"
                        for d, w in e["values"].items())
        lines.append(f"EQUIVOCATION: {e['sender']} {e['kind']} "
                     f"era={e['era']} epoch={e['epoch']} "
                     f"slot={e['slot']} values: {wit}")
    if res.equivocations:
        era, epoch = res.first_affected_epoch
        lines.append(f"first affected epoch: era={era} epoch={epoch}")
    for e in res.restart_reproposals:
        lines.append(f"RESTART RE-PROPOSAL (benign): {e['sender']} "
                     f"{e['kind']} era={e['era']} epoch={e['epoch']} — "
                     f"each value sent by a different incarnation")
    for j in res.sync_joins:
        v = j.get("verified_against")
        how = (f"boundary matches {v}" if v
               else "boundary uncorroborated — no overlapping journal")
        lines.append(f"STATE-SYNC JOIN: {j['node']}#{j['incarnation']} "
                     f"activated at chain index {j['index']} ({how})")
    for o in res.overload_incidents:
        kinds = " ".join(f"{k}×{n}" for k, n in o["kinds"].items())
        lines.append(f"OVERLOAD: peer {o['peer']} — {kinds} "
                     f"(witnessed by {', '.join(o['witnesses'])})")
    if res.vid_roots:
        lines.append(f"vid: {res.vid_roots} dispersed roots, "
                     f"{res.vid_corroborated} corroborated by ≥2 "
                     f"accounts")
    for v in res.vid_inconsistencies:
        if "error" in v:
            lines.append(f"VID MISMATCH: {v['error']}")
            continue
        wit = "; ".join(f"{d}<-{','.join(w)}"
                        for d, w in v["digests"].items())
        lines.append(f"VID MISMATCH: root={v['root'][:24]} — nodes "
                     f"read DIFFERENT payloads through one committed "
                     f"commitment: {wit}")
    for m in res.sync_mismatches:
        lines.append(f"SYNC MISMATCH: {m}")
    for m in res.status_mismatches:
        lines.append(f"STATUS MISMATCH: {m}")
    if res.unmatched_receives:
        lines.append(f"note: {res.unmatched_receives} receives had no "
                     f"matching journaled send (tampering, or the "
                     f"sender's journal rotated past them)")
    lines.append(f"verdict: {res.verdict}")
    return "\n".join(lines) + "\n"


def run_audit(paths: List[str]) -> Tuple[AuditResult, List[Journal]]:
    dirs: List[str] = []
    for p in paths:
        found = find_journal_dirs(p)
        if not found:
            raise FileNotFoundError(f"no journal segments under {p!r}")
        dirs.extend(found)
    journals = [read_journal(d) for d in dirs]
    return audit(journals), journals


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hbbft_tpu_torch.obs.audit", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+", metavar="DIR",
                    help="journal directories (or parents of node-*/)")
    ap.add_argument("--timeline", action="store_true",
                    help="print the full merged causal timeline")
    ap.add_argument("--json", action="store_true",
                    help="print the verdict document as JSON")
    ap.add_argument("--window", type=int, default=4,
                    help="epochs of context around a divergence")
    ap.add_argument("--status", action="append", default=[],
                    metavar="HOST:PORT",
                    help="cross-check a live node's /status chain head")
    ap.add_argument("--critpath", action="store_true",
                    help="append the per-tx critical-path report "
                         "(obs.critpath) over the same journals")
    args = ap.parse_args(argv)
    try:
        res, _journals = run_audit(args.paths)
    # hblint: disable=fault-swallowed-drop (CLI entry: exit status 2 is
    # the accounting — there is no registry in an offline audit run)
    except (FileNotFoundError, OSError) as exc:
        print(f"audit: {exc}", file=sys.stderr)
        return 2
    for target in args.status:
        from hbbft_tpu_torch.obs.http import http_get

        host, _, port = target.rpartition(":")
        try:
            doc = json.loads(http_get(host or "127.0.0.1", int(port),
                                      "/status"))
        # hblint: disable=fault-swallowed-drop (accounted: the appended
        # status_mismatch flips the verdict to fork and the exit to 1)
        except (OSError, ValueError) as exc:
            res.status_mismatches.append(f"{target}: unreachable "
                                         f"({exc!r})")
            continue
        cross_check_status(res, doc)
    cp_report = None
    if args.critpath:
        from hbbft_tpu_torch.obs import critpath as _critpath

        dirs: List[str] = []
        for p in args.paths:
            dirs.extend(find_journal_dirs(p))
        cp_report = _critpath.build_report(sorted(dirs))
    if args.json:
        doc = res.as_dict()
        if cp_report is not None:
            doc["critical_path"] = cp_report
        print(json.dumps(doc, sort_keys=True))
    else:
        sys.stdout.write(format_report(res, timeline=args.timeline,
                                       window=args.window))
        if cp_report is not None:
            print("-- critical path --")
            print(_critpath.render(cp_report))
    return 0 if res.verdict == "clean" else 1


if __name__ == "__main__":
    sys.exit(main())
