"""The flight recorder and the span tracer: the port against the JAX package.

One N = 4 run of ``QueueingHoneyBadger`` over ``DynamicHoneyBadger`` (the
reference's audit scenario: encryption off, batches of 4, eight
transactions) on each package's ``VirtualNet`` with ``NetBuilder.flight``:
every node journals to ``<root>/node-<i>`` on the logical clock (record
sequence numbers), so the two packages must write the same files, byte for
byte.  The journals read back to the same records, and each node's span
tracer finishes the same spans.  A second run with encryption on and a
fault-free schedule covers the decrypt spans.  Tolerance: exact.
"""

import importlib
import os
import random

import pytest

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")
N = 4


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def record_run(pkg, root, encrypt: bool, txs: int = 8):
    NetworkInfo = m(pkg, "netinfo").NetworkInfo
    sim = m(pkg, "sim")
    dhb = m(pkg, "protocols.dynamic_honey_badger")
    hb = m(pkg, "protocols.honey_badger")
    qhb = m(pkg, "protocols.queueing_honey_badger")
    kw = {} if pkg == "hbbft_tpu" else {"device": "cpu"}
    infos = NetworkInfo.generate_map(list(range(N)), random.Random(13))
    schedule = hb.EncryptionSchedule.always() if encrypt else hb.EncryptionSchedule.never()
    net = sim.NetBuilder(list(range(N))).flight(root).using_step(
        lambda nid: qhb.QueueingHoneyBadger(
            dhb.DynamicHoneyBadger(infos[nid], infos[nid].secret_key(),
                                   rng=random.Random(100 + nid),
                                   encryption_schedule=schedule, **kw),
            batch_size=4, rng=random.Random(200 + nid)))
    for i in range(txs):
        net.send_input(i % N, qhb.TxInput(b"audit-tx-%d" % i))
    while net.queue and net.cranks < 20_000:
        net.crank()
    spans = {nid: net.observers[nid].spans.export_jsonl() for nid in net.node_ids()}
    net.close_observers()
    return net, spans


def journal_files(root):
    out = {}
    for node in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, node))):
            with open(os.path.join(root, node, name), "rb") as fh:
                out[f"{node}/{name}"] = fh.read()
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "encrypted"])
def runs(request, tmp_path_factory):
    out = {}
    for pkg in PKGS:
        root = str(tmp_path_factory.mktemp(f"flight-{pkg}-{request.param}"))
        net, spans = record_run(pkg, root, request.param)
        out[pkg] = (root, net, spans)
    return out


def test_journal_files_are_byte_identical(runs):
    ref, port = (journal_files(runs[p][0]) for p in PKGS)
    assert sorted(port) == sorted(ref) and len(ref) >= N
    for name in ref:
        assert port[name] == ref[name], name


def test_journals_read_back_to_the_same_records(runs):
    got = []
    for pkg in PKGS:
        flight = m(pkg, "obs.flight")
        root = runs[pkg][0]
        per_node = []
        for node in sorted(os.listdir(root)):
            j = flight.read_journal(os.path.join(root, node))
            per_node.append([flight.record_as_dict(r) for _inc, r in j.records])
        got.append(per_node)
    assert got[0] == got[1]
    kinds = {rec["type"] for node in got[1] for rec in node}
    assert {"FlightHello", "FlightMsg", "FlightCommit", "FlightSpan"} <= kinds


def test_spans_match_reference(runs):
    ref, port = runs[PKGS[0]][2], runs[PKGS[1]][2]
    assert port == ref
    assert all(ref[nid] for nid in ref)


def test_ledgers_match_reference(runs):
    wires = [m(p, "protocols.wire") for p in PKGS]
    ledgers = []
    for pkg, wire in zip(PKGS, wires):
        net = runs[pkg][1]
        ledgers.append({nid: [wire.batch_bytes(o) for o in net.nodes[nid].outputs
                              if type(o).__name__ == "QhbBatch"]
                        for nid in net.node_ids()})
    assert ledgers[0] == ledgers[1]
    assert ledgers[1][0]
