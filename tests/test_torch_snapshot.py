"""``snapshot.py``: checkpoints and join snapshots, the port against the JAX
package.

- **Join snapshots.** A committed DKG transcript built as the reference's
  ``tests/test_statesync.py`` builds it (four validators and one absent
  candidate, every Part and Ack signed by its sender) in both packages:
  equal ``encode_join_snapshot`` bytes, the decode round trip and its
  refusals, the candidate's ``derive_secret_share`` (equal share, and it
  combines with a validator's into the key set's signature), tampered and
  truncated transcripts refused.  ``capture_join_snapshot`` of a fresh DHB
  and the config-share fallback; ``build_joiner``'s stack and its first
  proposal's wire bytes.
- **Dense state.** ``save_arrays`` of the port's tensors writes the bytes the
  reference writes for the equal numpy arrays; ``load_arrays`` returns numpy.
- **Object state.** A port ``HoneyBadger`` network and the VID node stack,
  snapshotted mid-run node by node, restored and run on, give the
  reference's uninterrupted outputs; a restored machine's own snapshot is
  byte-identical to the one it came from, and no snapshot holds a tensor
  (the erasure coders, which cache device bit matrices under the ``device``
  backend, pickle as their shape).

Tolerance: exact.
"""

import hashlib
import io
import pickle
import random

import numpy as np
import pytest
import torch

from test_torch_obj_protocols import PORT, REF, canon, infos, make_net
from test_torch_sender_queue import push_txs, stack_net, stack_summary, x


def kw(p):
    return {} if p is REF else {"device": "cpu"}


def manual_dkg(p, n_old=4, joiner_id=9):
    """The reference test's committed transcript among ``n_old`` present
    validators and one absent candidate."""
    dhb, tc = p.dhb, p.tc
    skg_mod = __import__(p.dhb.__name__.replace("dynamic_honey_badger", "sync_key_gen"),
                         fromlist=["SyncKeyGen"])
    rng = random.Random(42)
    ids = list(range(n_old)) + [joiner_id]
    sks = {i: tc.SecretKey.random(rng) for i in ids}
    pub = {i: sks[i].public_key() for i in ids}
    threshold = (len(ids) - 1) // 3
    kgs = {i: skg_mod.SyncKeyGen(i, sks[i], pub, threshold, random.Random(100 + i), **kw(p))
           for i in range(n_old)}

    def signed(sender, kind, payload):
        return dhb.SignedKeyGenMsg(0, sender, kind, payload,
                                   sks[sender].sign(dhb._keygen_payload(0, sender, kind, payload)))

    transcript = []
    for dealer in range(n_old):
        part = kgs[dealer].generate_part()
        transcript.append(signed(dealer, "part", dhb.ser_part(part)))
        acks = []
        for i in range(n_old):
            outcome = kgs[i].handle_part(dealer, part)
            assert outcome.fault is None
            if outcome.ack is not None:
                acks.append((i, outcome.ack))
        for i, ack in acks:
            transcript.append(signed(i, "ack", dhb.ser_ack(ack)))
            for j in range(n_old):
                assert kgs[j].handle_ack(i, ack).fault is None
    pks0, share0 = kgs[0].generate()
    snap = x(p).snapshot.JoinSnapshot(
        era=1, pub_key_set_bytes=pks0.commitment.to_bytes(),
        pub_keys=tuple(sorted(((i, pk.to_bytes()) for i, pk in pub.items()),
                              key=lambda kv: repr(kv[0]))),
        encryption_schedule=("never", 0, 0), transcript=tuple(transcript),
        chain_head=hashlib.sha3_256(b"boundary").digest(), chain_len=7)
    return snap, sks, pks0, share0, ids


def join(p):
    snap_mod = x(p).snapshot
    snap, sks, pks, share0, ids = manual_dkg(p)
    image = snap_mod.encode_join_snapshot(snap)
    assert snap_mod.decode_join_snapshot(image) == snap
    for bad in (image[:-1], b"XX" + image):
        with pytest.raises(ValueError):
            snap_mod.decode_join_snapshot(bad)
    joiner = ids[-1]
    share = snap_mod.derive_secret_share(snap, joiner, sks[joiner], **kw(p))
    msg = b"joined-era-1"
    sigs = {0: share0.sign(msg), sorted(ids).index(joiner): share.sign(msg)}
    assert pks.public_key().verify(pks.combine_signatures(sigs), msg)
    refusals = []
    for tampered, match in (
            (dict(pub_key_set_bytes=b"\x00" * len(snap.pub_key_set_bytes)),
             "different public key set"),
            (dict(transcript=snap.transcript[:1]), "does not complete")):
        bad = snap_mod.JoinSnapshot(**{**snap.__dict__, **tampered})
        with pytest.raises(ValueError, match=match) as err:
            snap_mod.derive_secret_share(bad, joiner, sks[joiner], **kw(p))
        refusals.append(str(err.value))
    # the joiner's stack: activated at the boundary, a full validator
    stack = snap_mod.build_joiner(snap, joiner, sks[joiner], batch_size=4, rng_seed=3, **kw(p))
    sq = x(p).sq
    step = stack.handle_input(p.qhb.TxInput(b"first-tx"))
    return {
        "image": image, "share": share.scalar, "refusals": refusals,
        "key": sq._algo_key(stack.algo), "validator": stack.algo.dhb.is_validator(),
        "pks": stack.algo.dhb.netinfo.public_key_set().commitment.to_bytes(),
        "step": [(sorted(tm.target.resolve(sorted(ids), joiner)), p.wire.encode_message(tm.message))
                 for tm in step.messages],
    }


def test_join_snapshot_matches_reference():
    got, ref = join(PORT), join(REF)
    assert got == ref
    assert got["validator"] and got["key"] == (1, 0)


def genesis_join(p):
    """``capture_join_snapshot`` of a fresh DHB: no transcript, so a
    config-derived validator falls back to its config share."""
    snap_mod = x(p).snapshot
    nets = infos(p, 4)
    dhb = p.dhb.DynamicHoneyBadger(nets[2], nets[2].secret_key(), **kw(p))
    snap = snap_mod.capture_join_snapshot(dhb, b"\x11" * 32, 0)
    assert snap.transcript == ()
    share = snap_mod.derive_secret_share(snap, 2, nets[2].secret_key(),
                                         config_netinfo=nets[2], **kw(p))
    none = snap_mod.derive_secret_share(snap, 2, nets[2].secret_key(), **kw(p))
    stack = snap_mod.build_joiner(snap, 2, nets[2].secret_key(), config_netinfo=nets[2], **kw(p))
    return (snap_mod.encode_join_snapshot(snap), share.scalar, none,
            stack.algo.dhb.is_validator(), stack.algo.batch_size)


def test_capture_join_snapshot_matches_reference():
    got = genesis_join(PORT)
    assert got == genesis_join(REF)
    assert got[2] is None and got[3] and got[4] == 8


def test_builders_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    snap, sks, _pks, _share, ids = manual_dkg(PORT)
    for make in (lambda: x(PORT).snapshot.derive_secret_share(snap, ids[-1], sks[ids[-1]]),
                 lambda: x(PORT).snapshot.build_joiner(snap, ids[-1], sks[ids[-1]])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- dense state ---------------------------------------------------------------


def dense_state(seed=4):
    rng = np.random.default_rng(seed)
    return {
        "shards": rng.integers(0, 256, (4, 3, 17), dtype=np.uint8),
        "limbs": rng.integers(-2**31, 2**31 - 1, (5, 13), dtype=np.int32),
        "digits": rng.integers(-2**62, 2**62, (7,), dtype=np.int64),
        "decided": rng.integers(0, 2, (4, 4)).astype(bool),
        "weights": rng.standard_normal((3, 3)).astype(np.float32),
        "epoch": np.int64(12),
    }


def test_save_arrays_of_tensors_gives_the_reference_bytes():
    state = dense_state()
    want = x(REF).snapshot.save_arrays(state)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    got = x(PORT).snapshot.save_arrays(tensors)
    assert got == want
    # a mix of tensors, arrays and scalars, as a state dict may hold
    mixed = {**tensors, "epoch": 12, "weights": state["weights"]}
    assert x(PORT).snapshot.save_arrays(mixed) == want
    back = x(PORT).snapshot.load_arrays(got)
    assert set(back) == set(state)
    for k, v in back.items():
        assert isinstance(v, np.ndarray) and v.dtype == np.asarray(state[k]).dtype
        assert np.array_equal(v, state[k])


def test_save_arrays_of_the_rbc_state():
    """The port's own dense state: the batched RBC's shard tensor."""
    from hbbft_tpu.ops import rs as jrs
    from hbbft_tpu_torch.ops import rs

    data = np.random.default_rng(5).integers(0, 256, (6, 2, 40), dtype=np.uint8)
    shards = rs.for_n_f(4, 1).encode(torch.from_numpy(data))
    want = np.stack([jrs.for_n_f(4, 1).encode_np(d) for d in data])
    assert (x(PORT).snapshot.save_arrays({"shards": shards})
            == x(REF).snapshot.save_arrays({"shards": want}))


# -- object state ---------------------------------------------------------------


def assert_tensor_free(obj) -> None:
    """Pickle ``obj`` as ``snapshot`` does, failing on any tensor in it."""
    class Pickler(pickle.Pickler):
        def persistent_id(self, o):
            if isinstance(o, torch.Tensor):
                raise AssertionError("the snapshot holds a tensor")
            return None

    Pickler(io.BytesIO(), protocol=pickle.HIGHEST_PROTOCOL).dump(obj)


def restore_all(p, net):
    """Snapshot every node's machine and swap the restored copy in: the
    snapshot is tensor-free, taken twice it is the same, and the restored
    machine snapshots to the same bytes."""
    snap_mod = x(p).snapshot
    for node in net.nodes.values():
        assert_tensor_free(node.algorithm)
        blob = snap_mod.snapshot(node.algorithm)
        assert snap_mod.snapshot(node.algorithm) == blob
        node.algorithm = snap_mod.restore(blob)
        assert snap_mod.snapshot(node.algorithm) == blob


def hb_node(p, nets, nid):
    b = (p.hb.HoneyBadger.builder(nets[nid]).rng(random.Random(nid))
         .encryption_schedule(p.hb.EncryptionSchedule.always()))
    return (b if p is REF else b.device("cpu")).build()


def run_hb(p, cut):
    nets = infos(p, 4)
    net, log = make_net(p, 4, lambda nid: hb_node(p, nets, nid))
    for nid in range(4):
        net.send_input(nid, b"contribution-%d" % nid * 30)
    while net.cranks < cut and net.crank() is not None:
        pass
    if p is PORT and cut:
        restore_all(p, net)
    net.run_to_quiescence()
    outputs = {nid: [canon(p, o) for o in net.nodes[nid].outputs] for nid in net.node_ids()}
    return outputs, net.cranks, log.total_bytes()


def test_restored_honey_badger_finishes_as_the_reference(monkeypatch):
    ref = run_hb(REF, 0)
    # the port under the device erasure backend on the CPU: its coders
    # cache bit-matrix tensors, which the snapshot must not carry
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "device")
    got = run_hb(PORT, 150)
    assert got == ref and all(got[0].values())


def run_vid(p, cut):
    net, log = stack_net(p, 4, vid=True)
    push_txs(p, net, 4, 12)
    while net.cranks < cut and net.crank() is not None:
        pass
    if p is PORT and cut:
        restore_all(p, net)
    net.run_to_quiescence()
    return stack_summary(p, net, log)


def test_restored_vid_stack_finishes_as_the_reference():
    ref = run_vid(REF, 0)
    got = run_vid(PORT, 200)
    assert got == ref
