"""The post-mortem tools, ``obs.audit`` (over ``obs.audit_stream``) and
``obs.critpath``: the port against the JAX package on the same journals.

The journals come from the port's ``VirtualNet`` with ``NetBuilder.flight``
at N = 4 (``QueueingHoneyBadger`` over ``DynamicHoneyBadger``, batches of 4,
eight transactions, keys from seed 13, device work on the CPU): a clean run,
a run with an equivocating proposer (node 3, crank-bounded), a copy of the
clean run with one segment torn mid-record, and two synthetic nodes whose
chains fork at index 3.  The port's journals are byte-identical to the
reference's (``tests/test_torch_obs_flight.py``), so each package's auditor
reads the same bytes.  Both give the same verdict, a byte-identical text
report with the merged timeline, and equal report JSON; the streaming
``IncrementalAuditor`` fed the same records, and the ``JournalTailer``
polling the directories, agree with the batch audit.  Over an encrypted run
on the cost model, both ``critpath`` reports are byte-identical, and every
reconstructed transaction's components sum to its total (to 1e-6 s, the
reference's own check of its rounded components).  Tolerance between the
packages: exact.
"""

import contextlib
import importlib
import io
import json
import os
import random
import shutil

import pytest

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")
N = 4


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def record_run(root, adversary=None, faulty=(), encrypt=False, cost=False,
               max_cranks=20_000):
    """A recorded run on the port's simulator (the journal writer under
    test elsewhere); crank-bounded, as an equivocator's queue never
    drains."""
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
    from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
    from hbbft_tpu_torch.protocols.queueing_honey_badger import (
        QueueingHoneyBadger, TxInput)
    from hbbft_tpu_torch.sim import NetBuilder, NullAdversary
    from hbbft_tpu_torch.sim.trace import CostModel

    infos = NetworkInfo.generate_map(list(range(N)), random.Random(13))
    schedule = EncryptionSchedule.always() if encrypt else EncryptionSchedule.never()
    builder = NetBuilder(list(range(N))).adversary(
        adversary or NullAdversary()).faulty(list(faulty)).flight(root)
    if cost:
        builder.cost_model(CostModel())
    net = builder.using_step(lambda nid: QueueingHoneyBadger(
        DynamicHoneyBadger(infos[nid], infos[nid].secret_key(),
                           rng=random.Random(100 + nid),
                           encryption_schedule=schedule, device="cpu"),
        batch_size=4, rng=random.Random(200 + nid)))
    for i in range(8):
        net.send_input(i % N, TxInput(b"audit-tx-%d" % i))
    while net.queue and net.cranks < max_cranks:
        net.crank()
    net.close_observers()
    return root


def fork_journals(root):
    from hbbft_tpu_torch.obs.flight import FlightRecorder

    shared = [bytes([i]) * 32 for i in range(3)]
    for node, fork_byte in (("0", 0xAA), ("1", 0xBB)):
        rec = FlightRecorder(os.path.join(root, f"node-{node}"), node=node, clock=None)
        for i, digest in enumerate(shared):
            rec.record_commit(0, i, i, digest)
        rec.record_commit(0, 3, 3, bytes([fork_byte]) * 32)
        rec.record_commit(0, 4, 4, bytes([fork_byte + 1]) * 32)
        rec.close()
    return root


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    from hbbft_tpu_torch.sim.adversary import EquivocatingAdversary

    base = tmp_path_factory.mktemp("audit")
    clean = record_run(str(base / "clean"))
    torn = str(base / "torn")
    shutil.copytree(clean, torn)
    node_dir = os.path.join(torn, sorted(os.listdir(torn))[0])
    seg = sorted(n for n in os.listdir(node_dir) if n.endswith(".fjl"))[-1]
    path = os.path.join(node_dir, seg)
    with open(path, "rb+") as fh:
        fh.truncate(os.path.getsize(path) - 11)
    return {
        "clean": clean,
        "equivocate": record_run(str(base / "equiv"), EquivocatingAdversary(), [3]),
        "torn": torn,
        "fork": fork_journals(str(base / "fork")),
    }


EXPECT = {"clean": "clean", "equivocate": "fault", "torn": "clean", "fork": "fork"}


def cli(pkg, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = m(pkg, "obs.audit").main(args)
    return rc, buf.getvalue()


@pytest.mark.parametrize("case", sorted(EXPECT))
def test_audit_matches_reference(journals, case):
    root = journals[case]
    got = {}
    for pkg in PKGS:
        audit = m(pkg, "obs.audit")
        res, _ = audit.run_audit([root])
        got[pkg] = (res.verdict, audit.format_report(res, timeline=True),
                    json.dumps(res.as_dict(), sort_keys=True),
                    cli(pkg, [root, "--timeline"]), cli(pkg, [root, "--json"]))
    assert got[PKGS[1]] == got[PKGS[0]]
    verdict, text, _doc, (rc, out), _ = got[PKGS[1]]
    assert verdict == EXPECT[case] and out == text
    assert rc == (0 if verdict == "clean" else 1)
    assert "-- timeline --" in text
    if case == "equivocate":
        assert "EQUIVOCATION: 3 " in text and "first affected epoch" in text
    if case == "torn":
        assert "1 torn tails" in text
    if case == "fork":
        assert "FORK: first divergent epoch era=0 epoch=3" in text


@pytest.mark.parametrize("case", sorted(EXPECT))
def test_incremental_auditor_matches_reference_and_batch(journals, case):
    """The streaming core fed record by record, and the tailer polling the
    directories, give the batch audit's verdict and timeline in both
    packages."""
    root = journals[case]
    got = {}
    for pkg in PKGS:
        flight, stream = m(pkg, "obs.flight"), m(pkg, "obs.audit_stream")
        aud = stream.IncrementalAuditor()
        for d in flight.find_journal_dirs(root):
            j = flight.read_journal(d)
            aud.add_node(j.node)
            for inc in j.incarnations:
                aud.observe_incarnation(j.node, inc)
            aud.add_torn(j.torn_tails)
            for inc, rec in j.records:
                aud.feed(j.node, inc, rec)
        tailer = stream.JournalTailer([root], stream.IncrementalAuditor())
        tailer.poll()
        tailer.finalize()
        batch, _ = m(pkg, "obs.audit").run_audit([root])
        docs = [json.dumps(r.as_dict(), sort_keys=True)
                for r in (aud.result(), tailer.result(), batch)]
        lines = [[e.line for e in r.events] for r in (aud.result(), batch)]
        got[pkg] = (docs[0], lines[0], tailer.result().verdict,
                    stream.extract_incidents(tailer.result()))
        assert docs[0] == docs[2] and lines[0] == lines[1]
    assert got[PKGS[1]] == got[PKGS[0]]


def test_status_cross_check_matches_reference(journals):
    """``--status``'s cross-check against a live node's chain tail: a
    matching tail stays clean, a disagreeing one is a fork, in both."""
    root = os.path.join(journals["fork"], "node-0")
    docs = [{"node": "0", "chain_len": 5, "digest_chain": [(bytes([2]) * 32).hex(),
                                                            (b"\xaa" * 32).hex()],
             "digest_chain_offset": 2}]
    docs.append(dict(docs[0], digest_chain=["ff" * 32, (b"\xaa" * 32).hex()]))
    got = {}
    for pkg in PKGS:
        audit = m(pkg, "obs.audit")
        out = []
        for doc in docs:
            res, _ = audit.run_audit([root])
            audit.cross_check_status(res, doc)
            out.append((res.verdict, res.status_mismatches))
        got[pkg] = out
    assert got[PKGS[1]] == got[PKGS[0]]
    assert [v for v, _ in got[PKGS[1]]] == ["clean", "fork"]


@pytest.fixture(scope="module")
def critpath_root(tmp_path_factory):
    return record_run(str(tmp_path_factory.mktemp("critpath")), encrypt=True, cost=True,
                      max_cranks=60_000)


def test_critpath_report_matches_reference(critpath_root):
    reports = {}
    for pkg in PKGS:
        cp = m(pkg, "obs.critpath")
        dirs = sorted(cp.find_journal_dirs(critpath_root))
        assert len(dirs) == N
        rep = cp.build_report(dirs)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cp.main([critpath_root])
        reports[pkg] = (json.dumps(rep, sort_keys=True), cp.render(rep), rc, buf.getvalue())
    assert reports[PKGS[1]] == reports[PKGS[0]]
    rep = json.loads(reports[PKGS[1]][0])
    assert rep["txs_committed"] >= 8 and rep["reconstructed_fraction"] == 1.0
    for row in rep["waterfalls"]:
        assert abs(sum(row["components"].values()) - row["total_s"]) < 1e-6, row
    for node, doc in rep["clock_offsets"].items():
        assert doc["bound_s"] is not None and doc["bound_s"] >= 0, node
