"""The node runtime's host units: the port against the JAX package.

The same inputs go through both packages' ``net/framing.py`` (frames,
coalesced message batches, hellos, challenge and auth payloads, and every
error case: oversize claims, zero-length frames, cuts, bad magic, version
mismatch, trailing bytes), ``net/client.py``'s ``Mempool`` (admission
verdicts under duplicates, the byte and entry caps, fair shedding,
commits), ``net/degrade.py``'s ``DegradationController`` on a scripted
clock (level transitions, the raise arm, the as-dict view and its
metrics) and ``net/statesync.py``'s ``SnapshotStore`` (the manifest and
every chunk of one join snapshot, and its refusals) as wire bytes.
Tolerance: exact.
"""

import importlib
import random
import struct

import pytest

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def outcome(fn):
    """``fn()``'s value, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except Exception as exc:  # the error cases are part of the contract
        return ("raise", type(exc).__name__, str(exc))


def framing_case(pkg):
    f = m(pkg, "net.framing")
    out = []
    payloads = [(f.HELLO, b"h" * 40), (f.MSG, b"\x70" + b"\x00" * 16),
                (f.PING, struct.pack(">Q", 7)), (f.TX, b"tx"), (f.STATUS_REQ, b""),
                (f.SYNC, b"\x90"), (f.AUTH, f.encode_auth(3, b"s" * 96))]
    stream = b"".join(f.encode_frame(k, p) for k, p in payloads)
    out.append(stream)
    dec = f.FrameDecoder()
    got = []
    for i in range(0, len(stream), 5):  # fed in 5-byte cuts
        got.extend(dec.feed(stream[i:i + 5]))
    out.append((got, dec.pending()))
    out.append(outcome(lambda: f.FrameDecoder(max_frame=1024).feed(
        struct.pack(">I", 2 ** 31) + b"\x02")))
    out.append(outcome(lambda: f.FrameDecoder().feed(struct.pack(">I", 0))))
    out.append(outcome(lambda: f.encode_frame(f.MSG, b"x" * 100, max_frame=50)))
    batch = [bytes([i]) * (i * 37 % 300 + 1) for i in range(40)]
    frames = f.pack_msgs(batch, 2048)
    out.append(frames)
    out.append([outcome(lambda fr=fr: f.split_msgs(fr[5:])) for fr in frames])
    out.append(outcome(lambda: f.split_msgs(b"\x00\x00\x00\x09abc")))
    nonce, session = bytes(range(f.NONCE_LEN)), bytes(range(f.SESSION_LEN))
    out.append(f.encode_challenge(nonce, session))
    out.append(outcome(lambda: f.decode_challenge(f.encode_challenge(nonce, session))))
    out.append(outcome(lambda: f.decode_challenge(b"\x01" * 5)))
    out.append(outcome(lambda: f.decode_auth(f.encode_auth(9, b"sig"))))
    out.append(outcome(lambda: f.decode_auth(b"\x00")))
    out.append(f.auth_transcript(b"cl", nonce, session, 3, f.ROLE_NODE, 2))
    for nid in (3, "node-a"):
        for role in (f.ROLE_NODE, f.ROLE_CLIENT):
            h = f.Hello(node_id=nid, role=role, cluster_id=b"cl/1", era=2, epoch=17)
            enc = f.encode_hello(h)
            out.append((enc, f.decode_hello(enc) == h))
    enc = f.encode_hello(f.Hello(node_id="n", role=f.ROLE_NODE, cluster_id=b"c",
                                 era=1, epoch=5))
    bad_version = bytearray(enc)
    bad_version[4:8] = struct.pack(">I", f.PROTOCOL_VERSION + 1)
    out.append(outcome(lambda: f.decode_hello(bytes(bad_version))))
    out.append(outcome(lambda: f.decode_hello(b"XXXX" + enc[4:])))
    out.append(outcome(lambda: f.decode_hello(enc + b"\x00")))
    out.append([outcome(lambda c=c: f.decode_hello(enc[:c])) for c in range(len(enc))])
    return out


def test_framing_matches_reference():
    assert framing_case(PKGS[1]) == framing_case(PKGS[0])


def mempool_case(pkg):
    client = m(pkg, "net.client")
    metrics = m(pkg, "obs.metrics")
    reg = metrics.Registry()
    pool = client.Mempool(capacity=16, seen_cap=8, max_tx_bytes=64,
                          max_pending_bytes=600, registry=reg)
    shed = []
    pool.on_shed = shed.append
    rng = random.Random(5)
    verdicts = []
    txs = [b"tx-%03d-" % i + rng.randbytes(rng.randrange(0, 60)) for i in range(60)]
    for i, tx in enumerate(txs):
        who = ("bulk", "a", "b", "c")[min(3, i % 7)]
        verdicts.append(pool.add(tx, client_id=who))
        if i % 5 == 0:
            verdicts.append(pool.add(tx, client_id=who))  # duplicate
    verdicts.append(pool.add(b"x" * 65, client_id="a"))  # oversized
    committed = pool.mark_committed(txs[:10] + [b"never-seen"])
    verdicts.append([pool.add(tx, client_id="a") for tx in txs[:12]])  # seen → dup
    digests = pool.mark_committed_digests([client.tx_digest(tx) for tx in txs[10:20]])
    return (verdicts, committed, digests, len(pool), pool.pending_bytes, shed,
            dict(pool.sheds), [pool.has_pending(client.tx_digest(tx)) for tx in txs],
            reg.render_prometheus(), client.latency_percentiles([0.5, 0.1, 0.3, 2.0]))


def test_mempool_verdicts_match_reference():
    ref = mempool_case(PKGS[0])
    assert mempool_case(PKGS[1]) == ref
    assert 0 in ref[0] and 1 in ref[0] and 3 in ref[0]  # accepted, duplicate, rejected


def degrade_case(pkg):
    degrade = m(pkg, "net.degrade")
    metrics = m(pkg, "obs.metrics")
    reg = metrics.Registry()
    clock, pressure, headroom, demand = [0.0], [0.0], [None], [0.0]
    applied, transitions = [], []
    ctl = degrade.DegradationController(
        sources=[("src", lambda: pressure[0])], apply_level=applied.append,
        registry=reg, window_s=1.0, engage_per_s=5.0, clear_per_s=1.0,
        clear_windows=2, max_level=3, max_boost=2, raise_windows=2,
        raise_headroom=0.5, headroom_fn=lambda: headroom[0],
        demand_fn=lambda: demand[0],
        on_transition=lambda *a: transitions.append(a), clock=lambda: clock[0])
    # (seconds, pressure added, headroom, demand) for each tick
    script = [(0.5, 100, None, 0), (1.0, 10, None, 0), (2.0, 10, None, 0),
              (3.0, 10, None, 0), (4.0, 10, None, 0), (5.0, 3, None, 0),
              (6.0, 0, None, 0), (7.0, 0, None, 0), (8.0, 0, 0.9, 1),
              (9.0, 0, 0.9, 1), (10.0, 0, 0.9, 1), (11.0, 0, 0.9, 1),
              (12.0, 0, 0.9, 1), (13.0, 0, 0.9, 1), (14.0, 0, 0.9, 1),
              (15.0, 0, 0.2, 1), (16.0, 3, 0.9, 1), (17.0, 50, 0.9, 1),
              (18.0, 0, 0.9, 0), (19.0, 0, 0.9, 0), (20.0, 0, 0.9, 0),
              (21.0, 0, 0.9, 1), (22.0, 0, 0.9, 1), (23.0, 0, 0.9, 1)]
    levels = []
    for t, dp, hr, dem in script:
        clock[0] = t
        pressure[0] += dp
        headroom[0] = hr
        demand[0] = dem
        ctl.tick()
        levels.append((ctl.level, ctl.as_dict()))
    sizes = [(degrade.DegradationController.shrink(64, lvl, 8),
              degrade.DegradationController.grow(64, lvl, 512)) for lvl in range(5)]
    return levels, applied, transitions, sizes, reg.render_prometheus()


def test_degrade_decisions_match_reference():
    ref = degrade_case(PKGS[0])
    assert degrade_case(PKGS[1]) == ref
    assert max(lvl for lvl, _ in ref[0]) > 0  # the ladder engaged
    assert max(d["boost"] for _, d in ref[0]) > 0  # and the raise arm


def statesync_case(pkg):
    NetworkInfo = m(pkg, "netinfo").NetworkInfo
    snapshot = m(pkg, "snapshot")
    sync = m(pkg, "net.statesync")
    metrics = m(pkg, "obs.metrics")
    wire = m(pkg, "protocols.wire")
    dhb = m(pkg, "protocols.dynamic_honey_badger")
    kw = {} if pkg == "hbbft_tpu" else {"device": "cpu"}
    nets = NetworkInfo.generate_map(list(range(25)), random.Random(3))  # > 1 chunk
    snap = snapshot.capture_join_snapshot(
        dhb.DynamicHoneyBadger(nets[0], nets[0].secret_key(), **kw), b"\x05" * 32, 11)
    reg = metrics.Registry()
    store = sync.SnapshotStore(reg, chunk_bytes=1024)
    replies = [store.handle(sync.SyncManifestReq())]  # nothing published: a nack
    store.publish(snap)
    man = store.handle(sync.SyncManifestReq())
    replies.append(man)
    replies += [store.handle(sync.SyncChunkReq(man.image_sha3, i))
                for i in range(man.n_chunks + 1)]  # the last index is out of range
    replies.append(store.handle(sync.SyncChunkReq(b"\x00" * 32, 0)))
    image = b"".join(r.data for r in replies[2:2 + man.n_chunks])
    back = snapshot.decode_join_snapshot(image)
    return ([wire.encode_message(r) for r in replies], man.n_chunks,
            snapshot.encode_join_snapshot(back) == image, reg.render_prometheus())


def test_statesync_manifest_and_chunks_match_reference():
    ref = statesync_case(PKGS[0])
    assert statesync_case(PKGS[1]) == ref
    assert ref[1] > 1 and ref[2]


@pytest.mark.parametrize("pkg", PKGS)
def test_frame_cap_is_the_wire_cap_plus_one(pkg):
    f, wire = m(pkg, "net.framing"), m(pkg, "protocols.wire")
    assert f.DEFAULT_MAX_FRAME == wire.MAX_MESSAGE_BYTES + 1
