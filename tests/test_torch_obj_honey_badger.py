"""Object-mode HoneyBadger: the port against the JAX package.

``HoneyBadger`` epochs (TPKE-encrypted contributions: RBC, ABA with the
threshold coin, threshold decryption) — two at N = 4, one at N = 7 — under
``NullAdversary`` and ``ReorderingAdversary(seed)``, built by each
package's ``HoneyBadgerBuilder`` from the same seeds (the port's with
``.device("cpu")``).  ``run_hb`` and ``pump`` (the deferred seam driven by
hand) serve ``test_torch_obj_device_route.py`` too.

Tolerance: exact — outputs (``wire.batch_bytes``), fault logs, crank
counts, ``EventLog`` counts and bytes by type and virtual time are equal.
"""

import random

import pytest

from test_torch_obj_protocols import PORT, REF, infos, make_net, summary

EPOCHS = {4: 2, 7: 1}


def build_hb(p, net_info, nid):
    b = (p.hb.HoneyBadger.builder(net_info).session_id(b"hb-parity")
         .rng(random.Random(100 + nid)))
    if p is PORT:
        b = b.device("cpu")
    return b.build()


def run_hb(p, n, adv, defer=False):
    nets = infos(p, n)

    def algo(nid):
        hb = build_hb(p, nets[nid], nid)
        hb.defer_decrypt = defer
        return hb

    net, log = make_net(p, n, algo, adv)
    for epoch in range(EPOCHS[n]):
        for nid in range(n):
            net.send_input(nid, b"epoch %d from %d " % (epoch, nid) * (nid + 1))
        pump(net)
    return net, log


def pump(net):
    """Crank to quiescence; then, as the runtime's pump does, resolve every
    node's parked share-set checks and fan out the steps, until none is
    left."""
    while True:
        net.run_to_quiescence()
        parked = [nid for nid in net.node_ids()
                  if net.nodes[nid].algorithm.has_deferred()]
        if not parked:
            return
        for nid in parked:
            node = net.nodes[nid]
            net._process_step(node, node.algorithm.resolve_deferred())


@pytest.mark.parametrize("n", [4, 7])
@pytest.mark.parametrize("adv", ["null", "reorder"])
def test_honey_badger_matches_reference(n, adv):
    ref = summary(REF, *run_hb(REF, n, adv))
    got = summary(PORT, *run_hb(PORT, n, adv))
    assert got == ref
    for outs in got["outputs"].values():
        assert [o[0] for o in outs] == ["Batch"] * EPOCHS[n]
    assert not any(got["faults"].values())


def test_builder_device_reaches_every_seam():
    """The builder's device is what each ``ThresholdDecrypt`` and each
    ``Broadcast`` of the epoch holds."""
    import torch

    nets = infos(PORT, 4)
    net, _ = make_net(PORT, 4, lambda nid: build_hb(PORT, nets[nid], nid))
    for nid in range(4):
        net.send_input(nid, b"x")
    net.crank_until(lambda nt: any(
        nt.nodes[i].algorithm.epochs.get(0) and nt.nodes[i].algorithm.epochs[0].decrypts
        for i in range(4)))
    hb = next(net.nodes[i].algorithm for i in range(4)
              if net.nodes[i].algorithm.epochs[0].decrypts)
    state = hb.epochs[0]
    assert hb.device == torch.device("cpu")
    assert {td.device for td in state.decrypts.values()} == {torch.device("cpu")}
    assert {p.broadcast.device for p in state.subset.proposals.values()} == {
        torch.device("cpu")}
