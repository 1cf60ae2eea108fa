"""The dynamic driver at n = 4: the port against the JAX package.

The same seeds go through ``hbbft_tpu.parallel.dhb`` and the port's
``parallel/dhb.py`` with ``device="cpu"``.  The ``DhbBatch`` sequences
(era, epoch, contributions, change state) must be equal: plain epochs, an
encryption-schedule change, and the remove-validator rotation, whose DKG
draws the same polynomials on both sides and so gives the same new key set.
The reference's rotation costs ~20–30 s on a CPU (its epochs compile for
every new payload shape), so that one comparison is marked ``slow``; the
port-only tests hold the port's rotations to the key sets the reference
gives for the same seeds, and to a working threshold decrypt under them."""

import hashlib
import io
import pickle
import random

import pytest
import torch

from hbbft_tpu.netinfo import NetworkInfo as JNetworkInfo
from hbbft_tpu.parallel.dhb import BatchedDynamicHoneyBadger as JDhb
from hbbft_tpu.protocols.honey_badger import EncryptionSchedule as JSchedule
from hbbft_tpu_torch.crypto import batch as tb
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.parallel.dhb import BatchedDynamicHoneyBadger
from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule

# SHA3-256 of the new era's PublicKeySet bytes that the JAX package's
# driver derives from these seeds (n = 4, network seed 31, session
# b"dhb-arr", rng 77, everyone votes node 3 out)
REF_REMOVE_KEYSET = "31510abe1a029e74493d929cabd07001b53b1ad4c99c0871efe5c19e00d8c698"


def _port(seed):
    return BatchedDynamicHoneyBadger(
        NetworkInfo.generate_map(list(range(4)), random.Random(seed)),
        session_id=b"dhb-arr", rng=random.Random(77), device="cpu")


def _ref(seed):
    return JDhb(JNetworkInfo.generate_map(list(range(4)), random.Random(seed)),
                session_id=b"dhb-arr", rng=random.Random(77))


def _key(b):
    """A DhbBatch as plain values, comparable across the two packages."""
    ch = b.change.change
    return (b.era, b.epoch, b.contributions, b.change.state,
            None if ch is None else (ch.kind, ch.new_keys, ch.schedule))


def _keyset_digest(dhb) -> str:
    return hashlib.sha3_256(
        dhb.netinfo_map[dhb.validators[0]].public_key_set().to_bytes()).hexdigest()


def _rotate(dhb, vote):
    vote(dhb)
    dhb.run_epoch({nid: b"e0-%d" % nid for nid in dhb.validators})
    final = dhb.run_until_change_completes()
    dhb.run_epoch({nid: b"era1-%d" % nid for nid in dhb.validators})
    return final


def _remove_3(dhb):
    for voter in range(4):
        dhb.vote_to_remove(voter, 3)


def _threshold_decrypt(dhb, msg: bytes) -> bytes:
    pks = dhb.netinfo_map[dhb.validators[0]].public_key_set()
    ct = pks.public_key().encrypt(msg, random.Random(3))
    shares = {dhb.netinfo_map[nid].node_index(nid):
              dhb.netinfo_map[nid].secret_key_share().decrypt_share(ct)
              for nid in dhb.validators[: pks.threshold() + 1]}
    return pks.decrypt(shares, ct)


def test_plain_epochs_match_reference():
    ref, got = _ref(31), _port(31)
    for e in range(2):
        contribs = {nid: b"user-%d-%d" % (nid, e) for nid in range(4)}
        want = ref.run_epoch(contribs)
        assert _key(got.run_epoch(contribs)) == _key(want)
    assert got.era == 0 and got.epoch == 2


def test_encryption_schedule_change_matches_reference():
    ref, got = _ref(9), _port(9)
    for voter in range(4):
        ref.vote_for_encryption_schedule(voter, JSchedule.every_nth_epoch(2))
        got.vote_for_encryption_schedule(voter, EncryptionSchedule.every_nth_epoch(2))
    for e in range(3):  # the rotation, then era 1's encrypted and plain epochs
        contribs = {nid: b"p-%d-%d" % (nid, e) for nid in got.validators}
        assert _key(got.run_epoch(contribs)) == _key(ref.run_epoch(contribs))
    assert got.era == ref.era == 1
    assert (got.encryption_schedule.kind, got.encryption_schedule.a) == ("nth", 2)
    assert got.encryption_schedule.encrypt_on_epoch(1) is False
    ref_plan, got_plan = ref.join_plan, got.join_plan
    with pytest.raises(ValueError):
        got_plan()  # era 1 has batches now
    with pytest.raises(ValueError):
        ref_plan()


@pytest.mark.slow
def test_remove_rotation_matches_reference():
    ref, got = _ref(31), _port(31)
    _rotate(ref, _remove_3)
    _rotate(got, _remove_3)
    assert [_key(b) for b in got.batches] == [_key(b) for b in ref.batches]
    assert (got.netinfo_map[0].public_key_set().to_bytes()
            == ref.netinfo_map[0].public_key_set().to_bytes())
    assert _keyset_digest(ref) == REF_REMOVE_KEYSET


def test_remove_rotation_completes_and_the_new_era_decrypts():
    dhb = _port(31)
    _remove_3(dhb)
    dhb.run_epoch({nid: b"e0-%d" % nid for nid in dhb.validators})
    final = dhb.run_until_change_completes()
    assert final.change.state == "complete" and final.change.change.kind == "nodes"
    plan = dhb.join_plan()  # valid at the era boundary
    assert plan.era == 1 and sorted(plan.key_map()) == [0, 1, 2]
    assert plan.public_key_set() == dhb.netinfo_map[0].public_key_set()
    dhb.run_epoch({nid: b"era1-%d" % nid for nid in dhb.validators})
    assert [b.change.state for b in dhb.batches] == [
        "in_progress", "in_progress", "complete", "none"]
    assert dhb.era == 1 and dhb.validators == [0, 1, 2]
    assert dict(dhb.batches[-1].contributions) == {n: b"era1-%d" % n for n in range(3)}
    assert _keyset_digest(dhb) == REF_REMOVE_KEYSET
    assert _threshold_decrypt(dhb, b"new era") == b"new era"


def test_dkg_runs_on_the_callers_device(monkeypatch):
    """With ``bivar_commitment`` forced onto the ladder, every member's
    commitment runs on the ``device`` it was given (the CPU here: the windowed
    ladder's plain version), and the rotation's key set is unchanged."""
    devices = []
    cache_for = tb.cache_for

    def spy(device):
        devices.append(torch.device(device))
        return cache_for(device)

    monkeypatch.setattr(tb, "cache_for", spy)
    monkeypatch.setattr(tb, "DEVICE_BIVAR_MIN_BATCH", 1)
    dhb = _port(31)
    _remove_3(dhb)
    dhb.run_epoch({nid: b"e0" for nid in range(4)})
    assert devices and set(devices) == {torch.device("cpu")}
    assert all(kg.device == torch.device("cpu") for kg in dhb.key_gens.values())
    dhb.run_until_change_completes()
    assert _keyset_digest(dhb) == REF_REMOVE_KEYSET


def test_snapshot_after_rotation_continues_the_same_batch():
    dhb = _port(31)
    _rotate(dhb, _remove_3)

    class Pickler(pickle.Pickler):
        def persistent_id(self, o):
            assert not isinstance(o, torch.Tensor), "a snapshot holds a tensor"
            return None

    buf = io.BytesIO()
    Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(dhb)
    restored = pickle.loads(buf.getvalue())
    restored.device = torch.device("cpu")
    contribs = {nid: b"after-%d" % nid for nid in range(3)}
    want = dhb.run_epoch(contribs, random.Random(8))
    assert _key(restored.run_epoch(contribs, random.Random(8))) == _key(want)
    assert [_key(b) for b in restored.batches] == [_key(b) for b in dhb.batches]
