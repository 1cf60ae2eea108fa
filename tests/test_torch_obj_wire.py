"""The wire codec's message registry: the port against the JAX package.

For every message type the port registers, a sample built from the same
seeded keys in both packages encodes to the same bytes, and those bytes
decode in the port to an equal, equally hashing message (and in the
reference to one that re-encodes to them).  The port registers exactly
the reference's tags: the object-mode, sender-queue and VID types, and the
flight-recorder, trace, health, performance and state-sync records.  Committed
batches give equal ``batch_bytes``, the live traffic of an N = 4
HoneyBadger epoch round-trips, and malformed input is refused as in the
reference.  ``sim/trace.py``'s wire sizes and net-frame tallies agree with
the reference's, and an unencodable message counts in the default
registry's ``hbbft_sim_wire_size_failures_total``.  Tolerance: exact, byte
for byte.
"""

import dataclasses
import random

import pytest

from test_torch_obj_protocols import PKGS, PORT, REF, infos, make_net



def samples(p):
    from importlib import import_module

    merkle = import_module(p.wire.__name__.replace("protocols.wire", "ops.merkle"))
    sq = import_module(p.wire.__name__.replace("wire", "sender_queue"))
    vid = import_module(p.wire.__name__.replace("wire", "vid"))
    flight = import_module(p.wire.__name__.replace("protocols.wire", "obs.flight"))
    trace = import_module(p.wire.__name__.replace("protocols.wire", "obs.trace"))
    sync = import_module(p.wire.__name__.replace("protocols.wire", "net.statesync"))
    rng = random.Random(77)
    sks = p.tc.SecretKeySet.random(1, rng)
    share = sks.secret_key_share(0).sign(b"doc")
    ct = sks.public_keys().public_key().encrypt(b"payload", rng)
    dshare = sks.secret_key_share(0).decrypt_share(ct)
    sig = p.tc.SecretKey(5).sign(b"x")
    tree = merkle.MerkleTree([b"shard-%d" % i for i in range(7)])
    bc, ba, ss, ts, td, hb, dhb = p.bc, p.ba, p.ss, p.ts, p.td, p.hb, p.dhb
    skg = dhb.SignedKeyGenMsg(1, 3, "part", b"\x00\x01\x02", sig)
    return [
        bc.ValueMsg(tree.proof(3)),
        bc.EchoMsg(tree.proof(0)),
        bc.ReadyMsg(tree.root_hash()),
        bc.EchoHashMsg(tree.root_hash()),
        bc.CanDecodeMsg(tree.root_hash()),
        ba.BValMsg(5, True),
        ba.AuxMsg(2, False),
        ba.ConfMsg(3, ba.BOTH),
        ba.ConfMsg(4, frozenset((False,))),
        ba.TermMsg(True),
        ba.CoinMsg(5, ts.ThresholdSignMessage(share)),
        ts.ThresholdSignMessage(share),
        td.DecryptionMessage(dshare),
        ss.BroadcastWrap(3, bc.ReadyMsg(b"\x07" * 32)),
        ss.AgreementWrap("node-a", ba.BValMsg(1, True)),
        hb.SubsetWrap(9, ss.BroadcastWrap(0, bc.ReadyMsg(b"\x01" * 32))),
        hb.DecryptionShareWrap(4, 2, td.DecryptionMessage(dshare)),
        dhb.HbWrap(2, hb.SubsetWrap(0, ss.AgreementWrap(1, ba.TermMsg(True)))),
        dhb.KeyGenWrap(1, skg),
        sq.EpochStarted((2, 17)),
        sq.AlgoMessage(dhb.HbWrap(1, hb.SubsetWrap(3, ss.BroadcastWrap(2, bc.ReadyMsg(b"\x05" * 32))))),
        vid.VidDisperse(3, tree.root_hash(), 1234, tree.proof(5)),
        vid.VidVote(3, tree.root_hash(), sig),
        vid.VidCert(3, tree.root_hash(), 1234, ((0, sig), ("node-b", sig))),
        vid.VidRetrieve(tree.root_hash()),
        vid.VidShard(tree.root_hash(), 1234, tree.proof(2)),
        flight.FlightHello("3", "runtime", 2, 17, 1.5),
        flight.FlightMsg(5, 2.25, "in", "1", 0, 4, "HbWrap", b"\x01\x02"),
        flight.FlightCommit(6, 3.0, 1, 9, 12, bytes(range(32))),
        flight.FlightFault(7, 3.5, "2", "MultipleDecryptionShares", 0, 3),
        flight.FlightSpan(8, 4.0, "aba_bval", 0, 3, 2, 1.0, 3.75, 9),
        flight.FlightSpan(9, 4.0, "rbc_value", 0, 3, None, 1.0, 1.5, 1),
        flight.FlightNote(10, 4.5, "guard", "kind=auth_fail peer='x'"),
        sync.SyncManifestReq(),
        sync.SyncManifest(2, 40, b"\x07" * 32, b"\x09" * 32, 70000, 32768, 3),
        sync.SyncChunkReq(b"\x09" * 32, 1),
        sync.SyncChunk(b"\x09" * 32, 1, 0xDEADBEEF, b"chunk-bytes"),
        sync.SyncNack("no snapshot"),
        trace.FlightTrace(11, 5.0, "commit", 0, 4, 3, "", b"\x05" * 32),
        flight.HealthIncident(12, 6.0, "watchtower", "equivocation", "fault", "3",
                              "equivocation:3", "two values"),
        flight.PerfSnapshot(13, 7.0, "0", 1.0, 0.25, 0.5, '{"layers": {}}'),
    ]


def test_registry_matches_reference():
    REF.wire.ensure_registered()
    PORT.wire.ensure_registered()
    ref = {cls.__name__: tag for cls, (tag, _) in REF.wire._MSG_TAGS.items()}
    got = {cls.__name__: tag for cls, (tag, _) in PORT.wire._MSG_TAGS.items()}
    assert got == ref
    assert {type(m).__name__ for m in samples(PORT)} == set(got)


@pytest.mark.parametrize("i", range(len(samples(REF))))
def test_message_bytes_match_reference(i):
    ref_msg, msg = samples(REF)[i], samples(PORT)[i]
    data = PORT.wire.encode_message(msg)
    assert data == REF.wire.encode_message(ref_msg)
    cls = type(msg)
    assert dataclasses.is_dataclass(cls) and cls.__dataclass_params__.frozen
    back = PORT.wire.decode_message(data)
    assert back == msg and hash(back) == hash(msg)
    assert REF.wire.encode_message(REF.wire.decode_message(data)) == data


def _batches(p):
    q = p.qhb
    change = p.dhb.Change.node_change(
        {nid: ni.public_key(nid) for nid, ni in infos(p, 4).items()})
    return [
        p.hb.Batch(3, ((0, b"a"), (2, b"bc"))),
        p.dhb.DhbBatch(1, 2, ((1, b"x"), ("n", b"")),
                       p.dhb.ChangeState.in_progress(change)),
        p.dhb.DhbBatch(0, 0, (), p.dhb.ChangeState.none()),
        q.QhbBatch(2, 5, ((0, (b"t1", b"t2")), (3, ())),
                   p.dhb.ChangeState.complete(change)),
    ]


def test_batch_bytes_match_reference():
    got = [PORT.wire.batch_bytes(b) for b in _batches(PORT)]
    assert got == [REF.wire.batch_bytes(b) for b in _batches(REF)]
    assert len(set(got)) == len(got)


def test_live_honey_badger_traffic_roundtrips():
    """Every message an N = 4 HoneyBadger epoch carries decodes back to
    itself, and the epoch's delivery stream is byte-equal to the
    reference's."""

    def stream(p):
        nets = infos(p, 4)
        net, _ = make_net(p, 4, lambda nid: p.hb.HoneyBadger(
            nets[nid], rng=random.Random(nid), **p.kw))
        for nid in range(4):
            net.send_input(nid, b"live-%d" % nid)
        out = []
        while True:
            msg = net.crank()
            if msg is None:
                return out
            data = p.wire.encode_message(msg.payload)
            if p is PORT:
                assert p.wire.decode_message(data) == msg.payload
            out.append((msg.sender, msg.to, data))

    got = stream(PORT)
    assert len(got) > 100
    assert got == stream(REF)


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_malformed_input_is_refused(p):
    w, ba = p.wire, p.ba
    with pytest.raises(TypeError):
        w.encode_message(object())
    with pytest.raises(ValueError):
        w.decode_message(b"\xff\x00")
    good = w.encode_message(ba.BValMsg(0, True))
    with pytest.raises(ValueError):
        w.decode_message(good + b"\x00")
    with pytest.raises(ValueError):
        w.decode_message(good[:-1])
    bomb = (b"\x60" + (0).to_bytes(8, "big")) * 2000 + w.encode_message(ba.TermMsg(True))
    with pytest.raises(ValueError):
        w.decode_message(bomb)
    enc = bytearray(w.encode_message(samples(p)[0]))
    enc[-1] = 2  # a proof's sibling-side flag that is neither 0 nor 1
    with pytest.raises(ValueError):
        w.decode_message(bytes(enc))


def test_event_log_net_tallies_match_reference():
    """``EventLog``'s net-frame tallies (metrics-registry counters in both
    packages) sum to the same values."""
    logs = []
    for p in PKGS:
        log = p.sim.EventLog()
        for i, (d, kind, nb) in enumerate([("send", "MSG", 40), ("recv", "MSG", 52),
                                           ("send", "PING", 9), ("send", "MSG", 7)]):
            log.record_net(p.sim.NetEvent(d, i % 2, kind, nb, float(i)))
        logs.append((log.net_frames_by_kind(), log.net_bytes_by_kind(),
                     log.net_total_bytes(), log.net_total_bytes("send"),
                     log.net_total_bytes("recv")))
    assert logs[0] == logs[1] == ({"MSG": 3, "PING": 1}, {"MSG": 99, "PING": 9}, 108, 56, 52)


def test_wire_size_counts_what_it_cannot_encode():
    from hbbft_tpu_torch.obs.metrics import DEFAULT
    from hbbft_tpu_torch.sim import trace

    def failures():
        fam = DEFAULT.get("hbbft_sim_wire_size_failures_total")
        return 0 if fam is None else fam.value(type="HbWrap/object")

    before = failures()
    bad = PORT.dhb.HbWrap(0, object())
    assert trace.wire_size(bad) == 0
    assert trace.wire_size(bad) == 0
    assert failures() == before + 2
    assert trace.wire_size(PORT.ba.TermMsg(True)) == len(
        REF.wire.encode_message(REF.ba.TermMsg(True)))
