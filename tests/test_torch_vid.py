"""Verifiable information dispersal: the port against the JAX package.

``protocols/vid.py`` (dispersal, votes, certificates, the ``VID1``
commitment codec) and ``net/retrieve.py`` (``ShardStore``,
``RetrieveService``), the port's with ``device="cpu"``, through the
sans-I/O scenarios of the reference's ``tests/test_vid.py``: the disperse →
vote → certificate round trip, a misdirected shard, a forged donor shard,
a retrieve for an unknown root, the serve quota, a non-codeword dispersal,
exhausted retrievals, the in-flight cap and the store's byte cap.  Then the
whole VID node stack, ``SenderQueue(VidQueueingHoneyBadger(DHB))``, on each
package's ``VirtualNet``, unshaped and under every link-shaping preset, with
every commitment retrieved afterwards by a plain loop between the nodes'
``RetrieveService``s.

Tolerance: exact.  Roots, the messages' wire bytes, the certificates, the
counters, the notes and the faults (sender and kind) are equal, and each
scenario's own claims hold in both packages.
"""

import random
from collections import deque

import pytest

from test_torch_obj_protocols import PORT, REF, infos
from test_torch_sender_queue import SHAPES, push_txs, stack_net, stack_summary, x

N, F = 4, 1  # k = n − 2f = 2


def kw(p):
    return {} if p is REF else {"device": "cpu"}


def disperser(p):
    return x(p).vid.Disperser(x(p).retrieve.ShardStore(), **kw(p))


def service(p, our_id, **opts):
    return x(p).retrieve.RetrieveService(our_id, x(p).retrieve.ShardStore(), **opts, **kw(p))


def wire(p, msg):
    return p.wire.encode_message(msg)


def faults(step):
    return [(f.node_id, f.kind.name) for f in step.fault_log.faults]


def _disperse(p, nets, payload, era=0, proposer=0):
    d = disperser(p)
    root, step = d.disperse(era, nets[proposer], payload)
    all_ids = sorted(nets.keys())
    by_dest, proofs = {}, {}
    for tm in step.messages:
        assert isinstance(tm.message, x(p).vid.VidDisperse)
        for dest in tm.target.resolve(all_ids, proposer):
            by_dest[dest] = tm.message
            proofs[tm.message.proof.index] = tm.message.proof
    own = d.store.proof_for(root)
    proofs[own[1].index] = own[1]
    return root, proofs, d, by_dest


def _notes():
    seen = []
    return seen, lambda kind, detail: seen.append((kind, detail))


# -- scenarios: each returns what the test compares, and asserts the
# -- reference test's claims in whichever package it runs ------------------


def roundtrip(p, n=N):
    f = (n - 1) // 3
    nets = infos(p, n, 21)
    vid = x(p).vid
    payload = random.Random(3).randbytes(700)
    root, _proofs, prop, by_dest = _disperse(p, nets, payload)
    assert len(by_dest) == n - 1
    out = {"root": root, "disperse": {d: wire(p, m) for d, m in by_dest.items()}}
    votes = []
    for nid, msg in sorted(by_dest.items()):
        recv = disperser(p)
        step = recv.handle_disperse(nets[nid], 0, msg)
        assert step.fault_log.is_empty() and recv.store.known(root)
        (tm,) = step.messages
        votes.append((nid, tm.message))
        (again,) = recv.handle_disperse(nets[nid], 0, msg).messages
        assert again.message == tm.message and recv.votes_cast == 1
    out["votes"] = [wire(p, v) for _, v in votes]
    bad = vid.VidVote(0, root, nets[1].secret_key().sign(b"wrong transcript"))
    step, cert = prop.handle_vote(nets[0], 1, bad)
    assert cert is None
    out["bad_vote"] = faults(step)
    assert out["bad_vote"] == [(1, "VidInvalidVote")]
    cert = None
    for nid, v in votes:
        step, c = prop.handle_vote(nets[0], nid, v)
        assert step.fault_log.is_empty()
        cert = cert or c
    assert cert.root == root and cert.total_len == len(payload)
    assert len(cert.votes) >= n - f and vid.verify_cert(cert, nets[0]) and prop.certs == 1
    commitment = vid.encode_commitment(cert)
    assert vid.decode_commitment(commitment) == cert
    assert vid.decode_commitment(b"plain payload, not a commitment") is None
    tampered = vid.VidCert(cert.era + 1, cert.root, cert.total_len, cert.votes)
    assert not vid.verify_cert(tampered, nets[0])
    # a junk vote beside n − f good ones: the aggregate fails, the
    # per-vote fallback still counts the good ones
    junk = vid.VidCert(cert.era, cert.root, cert.total_len,
                       cert.votes[:n - f] + ((n - 1, bad.sig),))
    assert vid.verify_cert(junk, nets[0])
    out.update(cert=wire(p, cert), commitment=commitment,
               counters=(prop.disperses, prop.votes_cast, prop.certs),
               digest=vid.payload_digest(payload),
               transcript=vid.vote_transcript(0, root, len(payload)))
    return out


def misdirected(p):
    nets = infos(p, N, 21)
    root, _proofs, _prop, by_dest = _disperse(p, nets, b"misdirected" * 40)
    recv = disperser(p)
    step = recv.handle_disperse(nets[2], 0, by_dest[1])
    assert faults(step) == [(0, "VidInvalidDisperse")]
    assert not step.messages and recv.votes_cast == 0 and not recv.store.known(root)
    return root, faults(step)


def bad_donor(p):
    nets = infos(p, N, 21)
    payload = random.Random(5).randbytes(900)
    root, proofs, _prop, _ = _disperse(p, nets, payload)
    notes, on_note = _notes()
    svc = service(p, 9, on_note=on_note)
    step = svc.start(root, len(payload), N, F, proposer=0, now=0.0, t_ordered=0.0)
    first = [wire(p, tm.message) for tm in step.messages]
    assert first == [wire(p, x(p).vid.VidRetrieve(root))]
    good = proofs[1]
    forged = x(p).merkle.Proof(value=bytes(len(good.value)), index=good.index,
                               root_hash=good.root_hash, path=good.path)
    step = svc.handle_shard(1, x(p).vid.VidShard(root, len(payload), forged), 0.1)
    assert svc.shards_bad == 1 and faults(step) == [(1, "VidShardProofInvalid")]
    outs = []
    for idx in (2, 3):
        outs.extend(svc.handle_shard(idx, x(p).vid.VidShard(root, len(payload), proofs[idx]),
                                     0.2).output)
    (rp,) = outs
    assert rp.payload == payload and rp.shards_bad == 1
    assert svc.retrieved == 1 and svc.mismatches == 0 and svc.pending_count() == 0
    step = svc.handle_shard(2, x(p).vid.VidShard(root, len(payload), proofs[2]), 0.3)
    assert svc.stray_shards == 1 and step.fault_log.is_empty()
    return first, notes, repr(rp), {k: v for k, v in vars(svc).items() if isinstance(v, int)}


def unknown_root(p):
    nets = infos(p, N, 21)
    notes, on_note = _notes()
    svc = service(p, 0, on_note=on_note)
    unknown = b"\x07" * 32
    step = svc.handle_retrieve(2, x(p).vid.VidRetrieve(unknown), now=0.0)
    assert not step.messages and step.fault_log.is_empty()
    assert svc.refusals == 1 and svc.served == 0
    assert notes == [("vid_refusal", f"peer=2 root={unknown.hex()[:24]}")]
    root, proofs, _prop, _ = _disperse(p, nets, b"late" * 100)
    svc.store.put(root, 400, proofs[0])
    (tm,) = svc.handle_retrieve(2, x(p).vid.VidRetrieve(root), now=0.0).messages
    assert tm.message.root == root and svc.served == 1
    return notes, wire(p, tm.message)


def quota(p):
    nets = infos(p, N, 21)
    root, proofs, _prop, _ = _disperse(p, nets, b"q" * 800)
    shard_len = len(proofs[0].value)
    notes, on_note = _notes()
    svc = service(p, 0, on_note=on_note, serve_bytes_per_s=shard_len,
                  serve_burst_bytes=shard_len)
    svc.store.put(root, 800, proofs[0])
    got = [bool(svc.handle_retrieve(peer, x(p).vid.VidRetrieve(root), now=t).messages)
           for peer, t in ((2, 0.0), (2, 0.0), (3, 0.0), (2, 1.5))]
    assert got == [True, False, True, True]
    assert svc.quota_drops == 1 and svc.served == 3
    assert any(k == "vid_quota" for k, _ in notes)
    return notes, sorted(svc._quota.items())


def non_codeword(p):
    merkle = x(p).merkle
    leaves = [bytes([65 + i]) * 20 for i in range(N)]
    tree = merkle.MerkleTree.from_vec(leaves)
    root = tree.root_hash()
    notes, on_note = _notes()
    svc = service(p, 9, on_note=on_note)
    svc.start(root, 10, N, F, proposer=3, now=0.0, t_ordered=0.0)
    svc.handle_shard(0, x(p).vid.VidShard(root, 10, tree.proof(0)), 0.1)
    step = svc.handle_shard(1, x(p).vid.VidShard(root, 10, tree.proof(1)), 0.2)
    (rp,) = step.output
    assert rp.payload is None and svc.mismatches == 1
    assert faults(step) == [(3, "VidReconstructMismatch")]
    assert any(k == "vid_mismatch" and "proposer=3" in d for k, d in notes)
    return notes, repr(rp)


def exhausted(p):
    notes, on_note = _notes()
    svc = service(p, 9, on_note=on_note, retry_s=0.5, max_rounds=2)
    root = b"\x42" * 32
    svc.start(root, 64, N, F, proposer=1, now=0.0, t_ordered=0.0)
    step = svc.tick(1.0)
    assert [tm.message for tm in step.messages] == [x(p).vid.VidRetrieve(root)]
    assert svc.retries == 1 and not step.output
    (rp,) = svc.tick(10.0).output
    assert rp.payload is None and rp.rounds == 2
    assert svc.failures == 1 and svc.pending_count() == 0 and svc.next_deadline() is None
    return notes, repr(rp)


def inflight_cap(p):
    vid = x(p).vid
    svc = service(p, 9, retry_s=0.5, max_rounds=2, max_inflight=1)
    r1, r2 = b"\x41" * 32, b"\x42" * 32
    log = []
    step = svc.start(r1, 64, N, F, proposer=1, now=0.0, t_ordered=0.0)
    log.append([tm.message for tm in step.messages])
    step = svc.start(r2, 64, N, F, proposer=2, now=0.0, t_ordered=0.0)
    log.append([tm.message for tm in step.messages])
    deadline = svc.next_deadline()
    log.append([tm.message for tm in svc.tick(1.0).messages])
    step = svc.tick(10.0)
    (rp,) = step.output
    log.append([tm.message for tm in step.messages])
    assert log == [[vid.VidRetrieve(r1)], [], [vid.VidRetrieve(r1)], [vid.VidRetrieve(r2)]]
    assert deadline == 0.5 and rp.root == r1 and rp.payload is None
    assert svc.pending_count() == 1 and svc.retries == 1
    return [[wire(p, m) for m in msgs] for msgs in log], repr(rp)


def targeted(p):
    """A retrieval with the holder map asks exactly the k − 1 missing
    holders from a root-derived offset, then broadcasts from round 2."""
    nets = infos(p, 7, 21)
    root, proofs, _prop, _ = _disperse(p, nets, random.Random(8).randbytes(1500))
    svc = service(p, 2, retry_s=0.5)
    svc.store.put(root, 1500, proofs[2])
    ids = tuple(range(7))
    rounds = []
    for t in (None, 1.0, 10.0):
        step = (svc.start(root, 1500, 7, 2, proposer=0, now=0.0, t_ordered=0.0, holders=ids)
                if t is None else svc.tick(t))
        rounds.append([sorted(tm.target.resolve(list(ids), 2)) for tm in step.messages])
    assert len(rounds[0]) == 2 and [2] not in rounds[0]  # k = 3, one shard our own
    assert rounds[2] == [[0, 1, 3, 4, 5, 6]]
    return rounds


def store_cap(p):
    nets = infos(p, N, 21)
    store_cls = x(p).retrieve.ShardStore
    entries = []
    for i in range(5):
        root, proofs, _prop, _ = _disperse(p, nets, bytes([i]) * 600, era=i)
        entries.append((root, proofs[0]))
    cost = store_cls._cost(entries[0][1])
    store = store_cls(max_bytes=3 * cost)
    for root, proof in entries:
        store.put(root, 600, proof)
    assert store.bytes <= store.max_bytes and store.evictions == 2 and len(store) == 3
    assert not store.known(entries[0][0]) and store.known(entries[4][0])
    before = store.bytes
    store.put(entries[2][0], 600, entries[2][1])
    assert store.bytes == before
    root5, proofs5, _p, _b = _disperse(p, nets, b"\xee" * 600, era=9)
    store.put(root5, 600, proofs5[0])
    assert store.evictions == 3
    assert store.known(entries[2][0]) and not store.known(entries[3][0])
    tiny = store_cls(max_bytes=1)
    tiny.put(entries[0][0], 600, entries[0][1])
    assert len(tiny) == 1
    return [root for root, _ in entries], cost, store.bytes, list(store._roots)


SCENARIOS = {
    "roundtrip": roundtrip,
    "roundtrip7": lambda p: roundtrip(p, 7),
    "misdirected": misdirected,
    "bad_donor": bad_donor,
    "unknown_root": unknown_root,
    "quota": quota,
    "non_codeword": non_codeword,
    "exhausted": exhausted,
    "inflight_cap": inflight_cap,
    "targeted": targeted,
    "store_cap": store_cap,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_vid_scenario_matches_reference(name):
    run = SCENARIOS[name]
    assert run(PORT) == run(REF)


# -- the VID node stack on VirtualNet, then retrieval --------------------------


def retrieve_all(p, net, n, f):
    """Every node retrieves every commitment it did not propose, from the
    other nodes' ``RetrieveService``s, over a plain FIFO loop.  Returns
    ``(services, {nid: [RetrievedPayload]}, faults, wire bytes)``."""
    vid = x(p).vid
    ids = net.node_ids()
    ni = net.nodes[ids[0]].algorithm.algo.dhb.netinfo
    holders = tuple(sorted(ids, key=ni.node_index))
    services = {nid: x(p).retrieve.RetrieveService(
        nid, net.nodes[nid].algorithm.algo.store, **kw(p)) for nid in ids}
    queue, got, seen_faults, stream = deque(), {nid: [] for nid in ids}, [], []

    def absorb(nid, step):
        for tm in step.messages:
            for dest in tm.target.resolve(ids, nid):
                queue.append((nid, dest, tm.message))
        got[nid].extend(step.output)
        seen_faults.extend((nid, f.node_id, f.kind.name) for f in step.fault_log.faults)

    for nid in ids:
        for out in net.nodes[nid].outputs:
            if isinstance(out, vid.VidQhbBatch):
                for proposer, cert in out.commitments():
                    if proposer != nid:
                        absorb(nid, services[nid].start(
                            cert.root, cert.total_len, n, f, proposer, now=0.0,
                            t_ordered=0.0, holders=holders))
    while queue:
        src, dst, msg = queue.popleft()
        stream.append(bytes([src, dst]) + wire(p, msg))
        if isinstance(msg, vid.VidRetrieve):
            absorb(dst, services[dst].handle_retrieve(src, msg, 0.0))
        else:
            absorb(dst, services[dst].handle_shard(src, msg, 0.0))
    return services, got, seen_faults, stream


def run_vid_stack(p, n, shape):
    f = (n - 1) // 3
    net, log = stack_net(p, n, vid=True, shape=shape)
    push_txs(p, net, n, 3 * n)
    net.run_to_quiescence()
    summary = stack_summary(p, net, log)
    services, got, seen_faults, stream = retrieve_all(p, net, n, f)
    counters = {nid: {k: v for k, v in vars(s).items() if isinstance(v, int)}
                for nid, s in services.items()}
    dispersal = {nid: (net.nodes[nid].algorithm.algo.disperser.disperses,
                       net.nodes[nid].algorithm.algo.disperser.votes_cast,
                       net.nodes[nid].algorithm.algo.disperser.certs)
                 for nid in net.node_ids()}
    payloads = {nid: [(rp.root, rp.proposer, rp.payload) for rp in outs]
                for nid, outs in got.items()}
    return net, {**summary, "retrieve": counters, "dispersal": dispersal,
                 "payloads": payloads, "retrieve_faults": seen_faults, "stream": stream}


def vid_ledger(p, net, nid, payloads):
    """A node's committed transactions: its own payloads from its
    disperser, the others' from retrieval, in commit order."""
    vid, qhb = x(p).vid, p.qhb
    by_root = {root: payload for root, _, payload in payloads}
    algo = net.nodes[nid].algorithm.algo
    out = []
    for o in net.nodes[nid].outputs:
        if isinstance(o, vid.VidQhbBatch):
            for proposer, cert in o.commitments():
                payload = (algo.disperser.local_payload(cert.root) if proposer == nid
                           else by_root[cert.root])
                out.extend(qhb._de_txs(payload))
            for _, txs in o.plain_txs():
                out.extend(txs)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s or "unshaped")
def test_vid_stack_matches_reference(shape):
    n = 4
    (_, ref), (net, got) = run_vid_stack(REF, n, shape), run_vid_stack(PORT, n, shape)
    assert got == ref
    # a duplicated frame is a repeated message: the protocols fault its
    # sender for it (dup-reorder); no other shape leaves a fault
    if not (got["shaper"] or {}).get("duplicated"):
        assert not any(got["faults"].values())
    assert not got["retrieve_faults"]
    for nid, c in got["retrieve"].items():
        assert c["mismatches"] == 0 and c["failures"] == 0 and c["retrieved"] == c["retrieves"]
    ledgers = {nid: vid_ledger(PORT, net, nid, got["payloads"][nid]) for nid in net.node_ids()}
    assert len({tuple(v) for v in ledgers.values()}) == 1
    assert sorted(ledgers[0]) == sorted(b"tx-%04d" % i for i in range(3 * n))


def test_vid_stack_at_seven_matches_reference():
    (_, ref), (_, got) = (run_vid_stack(p, 7, "bandwidth-asym") for p in (REF, PORT))
    assert got == ref
    assert sum(c["retrieved"] for c in got["retrieve"].values()) > 0


def test_disperser_and_service_default_to_cuda_and_raise_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    store = x(PORT).retrieve.ShardStore()
    for make in (lambda: x(PORT).vid.Disperser(store),
                 lambda: x(PORT).retrieve.RetrieveService(0, store)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
