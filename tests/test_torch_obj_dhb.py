"""Object-mode DynamicHoneyBadger at N = 4: the port against the JAX package.

A validator addition (node 4 joins from a ``JoinPlan`` as an observer, is
voted in, runs the DKG and contributes in era 1), driven the same way
through each package's ``VirtualNet`` from the same seeds (the port's
``device="cpu"``).  ``run_remove`` (node 3 voted out) is held to the
reference in ``test_torch_obj_remove.py``.

Tolerance: exact — every node's ``DhbBatch`` sequence (``batch_bytes``),
fault log, crank count, ``EventLog`` counts and bytes, virtual time, and
the new era's validator set and public key set (bytes) are equal.
"""

import random

from test_torch_obj_protocols import PORT, REF, infos, make_net, summary


def make_dhb(p, n, seed=31):
    nets = infos(p, n, seed)
    net, log = make_net(p, n, lambda nid: p.dhb.DynamicHoneyBadger(
        nets[nid], nets[nid].secret_key(), rng=random.Random(5000 + nid),
        encryption_schedule=p.hb.EncryptionSchedule.never(), **p.kw))
    return net, log


def drive_epoch(p, net, payload_fn, validators=None):
    ids = validators if validators is not None else net.node_ids()
    for nid in ids:
        net.send_input(nid, p.dhb.UserInput(payload_fn(nid)))
    net.run_to_quiescence()


def rotated(net):
    return all(net.nodes[nid].algorithm.era == 1 for nid in net.node_ids())


def era_state(p, net, dhb_of=lambda algo: algo):
    """Each node's era, validator ids, validator flag and public key set
    bytes (``dhb_of`` finds the DynamicHoneyBadger in a node's algorithm)."""
    from importlib import import_module

    bls = import_module(p.tc.__name__.replace(".tc", ".bls12_381"))
    out = {}
    for nid in net.node_ids():
        dhb = dhb_of(net.nodes[nid].algorithm)
        ni = dhb.netinfo
        out[nid] = (
            dhb.era,
            sorted(ni.all_ids()),
            ni.is_validator(),
            b"".join(bls.g1_to_bytes(pt) for pt in ni.public_key_set().commitment.points),
        )
    return out


def run_remove(p):
    net, log = make_dhb(p, 4)
    for nid in net.node_ids():
        keys = {k: net.nodes[nid].algorithm.netinfo.public_key(k) for k in (0, 1, 2)}
        net.send_input(nid, p.dhb.ChangeInput(p.dhb.Change.node_change(keys)))
    drive_epoch(p, net, lambda nid: b"payload")
    for _ in range(6):
        if rotated(net):
            break
        drive_epoch(p, net, lambda nid: b"more")
    drive_epoch(p, net, lambda nid: b"era1-%d" % nid, validators=[0, 1, 2])
    return summary(p, net, log), era_state(p, net)


def run_add(p):
    net, log = make_dhb(p, 4)
    cand_sk = p.tc.SecretKey.random(random.Random(99))
    plan = net.nodes[0].algorithm.join_plan()
    net.nodes[4] = p.vnet.Node(node_id=4, algorithm=p.dhb.DynamicHoneyBadger.from_join_plan(
        4, cand_sk, plan, rng=random.Random(5004), **p.kw))
    for nid in (0, 1, 2, 3):
        keys = {**net.nodes[nid].algorithm.netinfo.public_key_map(), 4: cand_sk.public_key()}
        net.send_input(nid, p.dhb.ChangeInput(p.dhb.Change.node_change(keys)))
    drive_epoch(p, net, lambda nid: b"x", validators=[0, 1, 2, 3])
    for _ in range(8):
        if rotated(net):
            break
        drive_epoch(p, net, lambda nid: b"y", validators=[0, 1, 2, 3])
    drive_epoch(p, net, lambda nid: b"from-%d" % nid)
    return summary(p, net, log), era_state(p, net)


def test_add_validator_matches_reference():
    (ref, ref_era), (got, got_era) = run_add(REF), run_add(PORT)
    assert got == ref
    assert got_era == ref_era
    assert all(s[:3] == (1, [0, 1, 2, 3, 4], True) for s in got_era.values())
    # the joiner's era-1 traffic reaching a node still in era 0
    assert {f for fl in got["faults"].values() for f in fl} == {(4, "UnknownSender")}
    # the joined node commits era 1's batches like the others
    era1 = [o for o in got["outputs"][0] if o[0] == "DhbBatch"]
    assert era1 == [o for o in got["outputs"][4] if o[0] == "DhbBatch"][-len(era1):]
