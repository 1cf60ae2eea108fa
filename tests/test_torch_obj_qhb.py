"""Object-mode QueueingHoneyBadger at N = 4: the port against the JAX package.

QHB over DHB (each built by its package's builders from the same seeds; the
port's DHB with ``.device("cpu")``), transactions pushed round-robin, and a
membership change voted through ``ChangeInput``: node 4 (joined from a
``JoinPlan``) added here, node 3 removed in ``test_torch_obj_remove.py``.  The run cranks to quiescence — the
DKG keep-alive proposes queued transactions — then commits a second wave
in the new era.

Tolerance: exact — every node's ``QhbBatch`` sequence (``batch_bytes``),
fault log, crank count, ``EventLog`` counts and bytes, virtual time and the
new era's validator and public key sets are equal; every transaction is
committed.
"""

import random

from test_torch_obj_dhb import era_state
from test_torch_obj_protocols import PORT, REF, infos, make_net, summary


def build_qhb(p, dhb_builder, nid):
    if p is PORT:
        dhb_builder = dhb_builder.device("cpu")
    dhb = dhb_builder.encryption_schedule(p.hb.EncryptionSchedule.never()).build()
    return (p.qhb.QueueingHoneyBadger.builder(dhb).batch_size(4)
            .rng(random.Random(2000 + nid)).build())


def push(p, net, ids, wave, count=24):
    for i in range(count):
        net.send_input(ids[i % len(ids)], p.qhb.TxInput(b"w%d-tx%02d" % (wave, i)))


def run_change(p, kind):
    nets = infos(p, 4, seed=41)
    net, log = make_net(p, 4, lambda nid: build_qhb(
        p, p.dhb.DynamicHoneyBadger.builder(nets[nid], nets[nid].secret_key())
        .rng(random.Random(1000 + nid)), nid))
    if kind == "add":
        cand_sk = p.tc.SecretKey.random(random.Random(98))
        plan = net.nodes[0].algorithm.dhb.join_plan()
        joiner = build_qhb(p, _JoinBuilder(p, cand_sk, plan), 4)
        net.nodes[4] = p.vnet.Node(node_id=4, algorithm=joiner)
        keys = {**nets[0].public_key_map(), 4: cand_sk.public_key()}
        final = [0, 1, 2, 3, 4]
    else:
        keys = {k: nets[0].public_key(k) for k in (0, 1, 2)}
        final = [0, 1, 2]
    push(p, net, [0, 1, 2, 3], 0)
    for nid in (0, 1, 2, 3):
        net.send_input(nid, p.dhb.ChangeInput(p.dhb.Change.node_change(keys)))
    net.run_to_quiescence()
    push(p, net, final, 1)
    net.run_to_quiescence()
    ledgers = {nid: [tx for o in net.nodes[nid].outputs
                     if isinstance(o, p.qhb.QhbBatch)
                     for _, txs in o.contributions for tx in txs]
               for nid in net.node_ids()}
    return (summary(p, net, log), era_state(p, net, lambda algo: algo.dhb), final,
            ledgers)


class _JoinBuilder:
    """The DHB builder's surface over ``DynamicHoneyBadger.from_join_plan``."""

    def __init__(self, p, sk, plan):
        self.p, self.sk, self.plan, self.kw = p, sk, plan, {}

    def device(self, device):
        self.kw["device"] = device
        return self

    def encryption_schedule(self, _schedule):
        return self  # a joiner takes the plan's schedule

    def build(self):
        return self.p.dhb.DynamicHoneyBadger.from_join_plan(
            4, self.sk, self.plan, rng=random.Random(1004), **self.kw)


def check_change(kind):
    ref, ref_era, final, _ = run_change(REF, kind)
    got, got_era, _, ledgers = run_change(PORT, kind)
    assert got == ref
    assert got_era == ref_era
    for nid, (era, ids, is_validator, _) in got_era.items():
        assert (era, ids, is_validator) == (1, final, nid in final)
    # every transaction of both waves committed, on every node (a sample
    # in flight when the era rotates is proposed again, as in the reference)
    for nid in final:
        assert set(ledgers[nid]) == {
            b"w%d-tx%02d" % (w, i) for w in (0, 1) for i in range(24)}


def test_add_validator_matches_reference():
    check_change("add")
