"""Object mode, protocol by protocol: the port against the JAX package.

The same seeded networks and inputs go through ``hbbft_tpu`` and
``hbbft_tpu_torch`` (``device="cpu"``) over each package's ``VirtualNet``
with an ``EventLog`` and a ``CostModel``: ``Broadcast``,
``BinaryAgreement``, ``Subset``, ``ThresholdSign`` and ``ThresholdDecrypt``
at N = 4 and 7, under ``NullAdversary``, ``ReorderingAdversary(seed)`` and,
for the broadcast-carrying protocols, an equivocating faulty node.

Tolerance: exact.  Every node's outputs (as canonical bytes), its fault log
(sender and kind), the crank and delivery counts, the ``EventLog``'s
message counts and wire bytes by type, and the virtual time must be equal.

The module also holds the harness the other ``test_torch_obj_*`` files
import: the two packages as namespaces, ``canon`` and ``summary``.
"""

import importlib
import random
from types import SimpleNamespace

import pytest


def _pkg(name: str) -> SimpleNamespace:
    base = "hbbft_tpu" if name == "ref" else "hbbft_tpu_torch"

    def m(path):
        return importlib.import_module(f"{base}.{path}")

    return SimpleNamespace(
        name=name,
        # the port's builders and protocols take a device; the tests run
        # its kernels' plain versions on the CPU
        kw={} if name == "ref" else {"device": "cpu"},
        NetworkInfo=m("netinfo").NetworkInfo,
        tc=m("crypto.tc"),
        sim=m("sim"),
        vnet=m("sim.virtual_net"),
        wire=m("protocols.wire"),
        bc=m("protocols.broadcast"),
        ba=m("protocols.binary_agreement"),
        ss=m("protocols.subset"),
        ts=m("protocols.threshold_sign"),
        td=m("protocols.threshold_decrypt"),
        hb=m("protocols.honey_badger"),
        dhb=m("protocols.dynamic_honey_badger"),
        qhb=m("protocols.queueing_honey_badger"),
    )


REF, PORT = _pkg("ref"), _pkg("port")
PKGS = (REF, PORT)

BATCH_TYPES = ("Batch", "DhbBatch", "QhbBatch")


def canon(p, o):
    """An output as package-independent bytes or text."""
    name = type(o).__name__
    if name in BATCH_TYPES:
        return (name, p.wire.batch_bytes(o))
    if hasattr(o, "to_bytes"):
        return (name, o.to_bytes())
    return repr(o)


def adversary(p, kind):
    if kind == "null":
        return p.sim.NullAdversary()
    if kind == "reorder":
        return p.sim.ReorderingAdversary(7)
    if kind == "equivocate":
        return p.sim.EquivocatingAdversary()
    raise ValueError(kind)


def make_net(p, n, algo, adv="null", faulty=()):
    """``(net, log)``: a ``VirtualNet`` of ``algo(nid)`` over ids
    0 … n−1 with an event log and the reference example's cost model."""
    log = p.sim.EventLog()
    net = (p.sim.NetBuilder(list(range(n))).faulty(faulty)
           .adversary(adversary(p, adv)).trace(log)
           .cost_model(p.sim.CostModel()).using_step(algo))
    return net, log


def summary(p, net, log):
    return {
        "outputs": {nid: [canon(p, o) for o in net.nodes[nid].outputs]
                    for nid in net.node_ids()},
        "faults": {nid: [(f.node_id, f.kind.name)
                         for f in net.nodes[nid].faults_observed]
                   for nid in net.node_ids()},
        "cranks": net.cranks,
        "delivered": net.messages_delivered,
        "types": log.messages_by_type(),
        "bytes": log.bytes_by_type(),
        "total_bytes": log.total_bytes(),
        "virtual_time": net.virtual_time,
    }


def infos(p, n, seed=11):
    return p.NetworkInfo.generate_map(list(range(n)), random.Random(seed))


# -- scenarios ---------------------------------------------------------------


def run_broadcast(p, n, adv):
    nets = infos(p, n)
    faulty = (n - 1,) if adv == "equivocate" else ()
    proposer = n - 1 if faulty else 0
    net, log = make_net(
        p, n, lambda nid: p.bc.Broadcast(nets[nid], proposer, **p.kw), adv, faulty)
    # shards past CAN_DECODE_MIN_SHARD_BYTES: CanDecode and EchoHash run
    value = random.Random(5).randbytes(3000)
    net.send_input(proposer, value)
    net.run_to_quiescence()
    return summary(p, net, log)


def run_agreement(p, n, adv):
    nets = infos(p, n)
    net, log = make_net(
        p, n, lambda nid: p.ba.BinaryAgreement(nets[nid], b"ba-session", 0), adv)
    # split inputs: the epochs run to the threshold-signature coin
    for nid in range(n):
        net.send_input(nid, nid % 2 == 0)
    net.run_to_quiescence()
    return summary(p, net, log)


def run_subset(p, n, adv):
    nets = infos(p, n)
    faulty = (n - 1,) if adv == "equivocate" else ()
    net, log = make_net(
        p, n, lambda nid: p.ss.Subset(nets[nid], b"acs-session", **p.kw), adv, faulty)
    rng = random.Random(6)
    for nid in range(n):
        net.send_input(nid, rng.randbytes(40 + 300 * nid))
    net.run_to_quiescence()
    return summary(p, net, log)


def run_sign(p, n, adv):
    nets = infos(p, n)
    net, log = make_net(p, n, lambda nid: p.ts.ThresholdSign(nets[nid]), adv)
    for nid in range(n):
        net.send_input(nid, b"the coin's document")
    net.run_to_quiescence()
    return summary(p, net, log)


def run_decrypt(p, n, adv):
    nets = infos(p, n)
    ct = nets[0].public_key_set().public_key().encrypt(b"a secret" * 9, random.Random(8))
    net, log = make_net(p, n, lambda nid: p.td.ThresholdDecrypt(nets[nid], **p.kw), adv)
    for nid in range(n):
        net.send_input(nid, ct)
    net.run_to_quiescence()
    return summary(p, net, log)


SCENARIOS = {
    "broadcast": (run_broadcast, ("null", "reorder", "equivocate")),
    "agreement": (run_agreement, ("null", "reorder")),
    "subset": (run_subset, ("null", "reorder", "equivocate")),
    "sign": (run_sign, ("null", "reorder")),
    "decrypt": (run_decrypt, ("null", "reorder")),
}
CASES = [(name, n, adv) for name, (_, advs) in SCENARIOS.items()
         for n in (4, 7) for adv in advs]


@pytest.mark.parametrize("name,n,adv", CASES, ids=lambda v: str(v))
def test_protocol_matches_reference(name, n, adv):
    run = SCENARIOS[name][0]
    ref, got = run(REF, n, adv), run(PORT, n, adv)
    assert got == ref
    assert got["delivered"] > 0
    if adv == "equivocate":
        # an equivocating proposer may stall its own instance; the
        # evidence must show either way
        assert any(got["faults"].values()), "the equivocation left no fault"
    else:
        assert all(got["outputs"].values()), "a node produced no output"
