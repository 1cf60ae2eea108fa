"""The node stack without the network: the port against the JAX package.

``SenderQueue`` over ``QueueingHoneyBadger`` (and over
``VidQueueingHoneyBadger``, in ``test_torch_vid.py``) as the reference's
``net/cluster.py`` ``build_algo`` builds every node: per-node seeded RNGs,
``DynamicHoneyBadger`` underneath (the port's with ``device="cpu"``).  The
same seeded networks and transactions go through both packages:

- on each package's ``VirtualNet`` with an ``EventLog`` and a ``CostModel``,
  unshaped and under every link-shaping preset of ``chaos/link.py``
  (``PRESETS`` plus ``bandwidth-asym``, scaled to the virtual clock);
- through the reference's catch-up pump (a peer restarts at (0, 0) and is
  re-fed its history through ``reinit_peer``), and ``reinit_peer`` alone.

Tolerance: exact.  Every node's outputs (``batch_bytes``), fault log, the
crank and delivery counts, the ``EventLog``'s counts and bytes by type, the
virtual time and the shaper's counters are equal.

The module also holds the stack harness ``test_torch_vid.py``,
``test_torch_adversary_zoo.py`` and ``test_torch_snapshot.py`` import.
"""

import importlib
import random
from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import pytest

from test_torch_obj_protocols import PORT, REF, infos


def _more(p) -> SimpleNamespace:
    base = "hbbft_tpu" if p is REF else "hbbft_tpu_torch"

    def m(path):
        return importlib.import_module(f"{base}.{path}")

    return SimpleNamespace(
        sq=m("protocols.sender_queue"),
        vid=m("protocols.vid"),
        retrieve=m("net.retrieve"),
        link=m("chaos.link"),
        adv=m("sim.adversary"),
        snapshot=m("snapshot"),
        rs=m("ops.rs"),
        merkle=m("ops.merkle"),
        fault_log=m("fault_log"),
        traits=m("traits"),
    )


X = {REF.name: _more(REF), PORT.name: _more(PORT)}
SHAPES = (None,) + tuple(X["ref"].link.PRESETS[1:]) + ("bandwidth-asym",)


def x(p) -> SimpleNamespace:
    return X[p.name]


def canon(p, o):
    """An output as package-independent bytes or text."""
    name = type(o).__name__
    if name in ("QhbBatch", "VidQhbBatch", "DhbBatch", "Batch"):
        return (name, p.wire.batch_bytes(o))
    if name == "VidCertReady":
        return (name, o.era, o.root, o.total_len, o.payload_sha3)
    return repr(o)


def build_stack(p, nets, nid, vid=False, encrypt=False, batch_size=8, seed=0):
    """``net/cluster.py`` ``build_algo``: SenderQueue(QHB or VID-QHB(DHB))."""
    b = (p.dhb.DynamicHoneyBadger.builder(nets[nid], nets[nid].secret_key())
         .rng(random.Random(seed * 100_000 + 7000 + nid)))
    if p is PORT:
        b = b.device("cpu")
    sched = (p.hb.EncryptionSchedule.always() if encrypt
             else p.hb.EncryptionSchedule.never())
    dhb = b.encryption_schedule(sched).build()
    cls = x(p).vid.VidQueueingHoneyBadger if vid else p.qhb.QueueingHoneyBadger
    qhb = cls(dhb, batch_size=batch_size,
              rng=random.Random(seed * 100_000 + 8000 + nid))
    return x(p).sq.SenderQueue(qhb)


def stack_net(p, n, vid=False, shape=None, adversary=None, faulty=(),
              seed=11, encrypt=False, batch_size=8):
    """``(net, log)``: the node stack on a ``VirtualNet`` with an event log,
    a cost model and, for ``shape``, the preset scaled to virtual seconds
    (1e-3, the campaign's default)."""
    nets = infos(p, n, seed)
    log = p.sim.EventLog()
    b = (p.sim.NetBuilder(list(range(n))).faulty(faulty).trace(log)
         .cost_model(p.sim.CostModel()))
    if adversary is not None:
        b = b.adversary(adversary)
    if shape is not None:
        b = b.shape(x(p).link.preset_shape(shape, n).scaled(1e-3), seed=5)
    net = b.using_step(lambda nid: build_stack(
        p, nets, nid, vid=vid, encrypt=encrypt, batch_size=batch_size))
    return net, log


def stack_summary(p, net, log) -> Dict[str, Any]:
    return {
        "outputs": {nid: [canon(p, o) for o in net.nodes[nid].outputs]
                    for nid in net.node_ids()},
        "faults": {nid: [(f.node_id, f.kind.name)
                         for f in net.nodes[nid].faults_observed]
                   for nid in net.node_ids()},
        "cranks": net.cranks,
        "delivered": net.messages_delivered,
        "filtered": net.adversary_filtered,
        "types": log.messages_by_type(),
        "bytes": log.bytes_by_type(),
        "total_bytes": log.total_bytes(),
        "virtual_time": net.virtual_time,
        "shaper": None if net.shaper is None else net.shaper.stats(),
        "held": [(n.sender, n.to) for _, _, n in net._held],
    }


def push_txs(p, net, n, count):
    for i in range(count):
        net.send_input(i % n, p.qhb.TxInput(b"tx-%04d" % i))


def run_stack(p, n, vid, shape, txs=None):
    net, log = stack_net(p, n, vid=vid, shape=shape)
    push_txs(p, net, n, 3 * n if txs is None else txs)
    net.run_to_quiescence()
    return net, stack_summary(p, net, log)


def committed_txs(p, net, nid) -> List[bytes]:
    """A classic node's committed transactions, in commit order."""
    return [tx for o in net.nodes[nid].outputs if isinstance(o, p.qhb.QhbBatch)
            for _, txs in o.contributions for tx in txs]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s or "unshaped")
def test_classic_stack_matches_reference(shape):
    n = 4
    (_, ref), (net, got) = run_stack(REF, n, False, shape), run_stack(PORT, n, False, shape)
    assert got == ref
    assert net.quiescent and (shape is not None or net.shaper is None)
    ledgers = {nid: committed_txs(PORT, net, nid) for nid in net.node_ids()}
    assert len({tuple(v) for v in ledgers.values()}) == 1
    assert sorted(set(ledgers[0])) == sorted(b"tx-%04d" % i for i in range(3 * n))
    if shape is not None:
        assert got["shaper"]["shaped"] > 0


def test_classic_stack_at_seven_matches_reference():
    (_, ref), (_, got) = (run_stack(p, 7, False, "bandwidth-asym") for p in (REF, PORT))
    assert got == ref and all(got["outputs"].values())


# -- catch-up: the restart path of the reference's node runtime ---------------

DOWN = 3  # the node that is down, then restarts at (0, 0)


def _catchup_node(p, nets, nid):
    dhb = p.dhb.DynamicHoneyBadger(
        nets[nid], nets[nid].secret_key(), rng=random.Random(7000 + nid),
        encryption_schedule=p.hb.EncryptionSchedule.never(), **p.kw)
    return x(p).sq.SenderQueue(p.qhb.QueueingHoneyBadger(
        dhb, batch_size=4, rng=random.Random(8000 + nid)))


class Pump:
    """The reference test's deterministic FIFO pump with a runtime-style
    replay log: messages to a down node are recorded in
    ``history[sender]`` as the runtime's per-peer replay log records them."""

    def __init__(self, p, nodes):
        self.p, self.nodes = p, nodes
        self.queue: List[Tuple[int, int, Any]] = []
        self.down: set = set()
        self.history: Dict[int, List[Tuple[Tuple[int, int], Any]]] = {}
        self.delivered_keys: Dict[int, List[Tuple[int, int]]] = {}
        self.wire: List[bytes] = []

    def fan_out(self, sender, step):
        all_ids = sorted(self.nodes.keys())
        for tm in step.messages:
            for dest in tm.target.resolve(all_ids, sender):
                self.queue.append((sender, dest, tm.message))

    def run(self):
        sq = x(self.p).sq
        while self.queue:
            sender, dest, msg = self.queue.pop(0)
            self.wire.append(bytes([sender, dest]) + self.p.wire.encode_message(msg))
            if dest in self.down:
                if isinstance(msg, sq.AlgoMessage):
                    self.history.setdefault(sender, []).append(
                        (sq.message_key(msg.msg), msg.msg))
                continue
            if dest == DOWN and isinstance(msg, sq.AlgoMessage):
                self.delivered_keys.setdefault(sender, []).append(sq.message_key(msg.msg))
            self.fan_out(dest, self.nodes[dest].handle_message(sender, msg))


def run_catchup(p):
    n = 4
    nets = p.NetworkInfo.generate_map(list(range(n)), random.Random(11))
    nodes = {nid: _catchup_node(p, nets, nid) for nid in range(n)}
    outputs = {nid: [] for nid in range(n)}
    pump = Pump(p, nodes)

    def wrap(nid):
        node = nodes[nid]
        inner = node.handle_message

        def handler(sender, msg):
            step = inner(sender, msg)
            outputs[nid].extend(o for o in step.output if isinstance(o, p.qhb.QhbBatch))
            return step

        node.handle_message = handler

    for nid in range(n):
        wrap(nid)
    pump.down = {DOWN}
    for e in range(7):
        for nid in range(n - 1):
            step = nodes[nid].handle_input(p.qhb.TxInput(b"tx-%d-%d" % (e, nid)))
            outputs[nid].extend(o for o in step.output if isinstance(o, p.qhb.QhbBatch))
            pump.fan_out(nid, step)
        pump.run()
    sq = x(p).sq
    k = sq._algo_key(nodes[0].algo)[1]
    window = nodes[0].algo.dhb.max_future_epochs
    held = {nid: [key for key, _ in nodes[nid].buffered.get(DOWN, [])] for nid in range(n - 1)}
    history = {nid: [key for key, _ in pump.history.get(nid, [])] for nid in range(n - 1)}

    nodes[DOWN] = _catchup_node(p, nets, DOWN)
    wrap(DOWN)
    pump.down = set()
    for nid in range(n - 1):
        pump.fan_out(nid, nodes[nid].reinit_peer(DOWN, (0, 0), pump.history.get(nid, [])))
    pump.run()
    return {
        "k": k, "window": window, "held": held, "history": history,
        "final_keys": [sq._algo_key(nodes[nid].algo) for nid in range(n)],
        "outputs": {nid: [p.wire.batch_bytes(b) for b in outs] for nid, outs in outputs.items()},
        "txs": {nid: [tuple(b.all_txs()) for b in outs] for nid, outs in outputs.items()},
        "delivered_keys": pump.delivered_keys,
        "wire": pump.wire,
        "peaks": [nodes[nid].buffered_peak for nid in range(n)],
    }


def test_restarted_peer_catches_up_in_order():
    ref, got = run_catchup(REF), run_catchup(PORT)
    assert got == ref
    # the reference test's own claims, on the port
    assert got["k"] >= 5
    for nid in range(DOWN):
        assert got["held"][nid] and all(key > (0, got["window"]) for key in got["held"][nid])
        assert any(key <= (0, got["window"]) for key in got["history"][nid])
        keys = got["delivered_keys"][nid]
        assert keys and keys == sorted(keys)
    assert got["final_keys"][DOWN] == got["final_keys"][0]
    assert got["txs"][DOWN] == got["txs"][0] and len(got["txs"][0]) >= 5


def run_reinit(p):
    nets = p.NetworkInfo.generate_map(list(range(4)), random.Random(13))
    node = _catchup_node(p, nets, 0)
    sq = x(p).sq
    window = node.algo.dhb.max_future_epochs
    node.peer_epochs[1] = (0, 9)

    def fake(epoch):
        return p.dhb.HbWrap(0, p.hb.SubsetWrap(epoch, None))

    node.buffered[1] = [((0, 14), fake(14)), ((0, 15), fake(15))]
    history = [((0, e), fake(e)) for e in range(6)]
    step = node.reinit_peer(1, (0, 0), history)
    sent = [tm.message for tm in step.messages]
    buffered = [key for key, _ in node.buffered[1]]
    # a second reinit with the same history is value-deduplicated
    node.reinit_peer(1, (0, 0), history)
    return {
        "window": window,
        "peer": node.peer_epochs[1],
        "sent": [(type(m).__name__, sq.message_key(m.msg) if isinstance(m, sq.AlgoMessage)
                  else m.key) for m in sent],
        "targets": [sorted(tm.target.resolve([0, 1, 2, 3], 0)) for tm in step.messages],
        "buffered": buffered,
        "again": [key for key, _ in node.buffered[1]],
    }


def test_reinit_peer_rewinds_and_rebuffers():
    ref, got = run_reinit(REF), run_reinit(PORT)
    assert got == ref
    w = got["window"]
    assert got["peer"] == (0, 0)
    assert [k for t, k in got["sent"] if t == "AlgoMessage"] == [(0, e) for e in range(w + 1)]
    assert got["buffered"] == [(0, e) for e in range(w + 1, 6)] + [(0, 14), (0, 15)]
    assert ("EpochStarted", (0, 0)) in got["sent"]
    assert got["again"] == got["buffered"]


def test_buffered_cap_chops_oldest_and_counts():
    """The per-peer backlog cap: past ``buffered_cap`` the lowest keys go,
    counted per peer and through ``on_evict``; the peak records the
    pre-chop length."""

    def run(p):
        nets = p.NetworkInfo.generate_map(list(range(4)), random.Random(13))
        evicted = []
        dhb = p.dhb.DynamicHoneyBadger(
            nets[0], nets[0].secret_key(), rng=random.Random(1),
            encryption_schedule=p.hb.EncryptionSchedule.never(), **p.kw)
        node = x(p).sq.SenderQueue(p.qhb.QueueingHoneyBadger(dhb, batch_size=4),
                                   buffered_cap=3, on_evict=lambda peer, k: evicted.append((peer, k)))
        start = node.startup_step()
        t = x(p).traits
        msgs = [t.TargetedMessage(t.Target.nodes([2]), p.dhb.HbWrap(0, p.hb.SubsetWrap(e, None)))
                for e in (40, 30, 50, 20, 60)]
        step = node._post(t.Step(messages=msgs))
        return (start.messages[0].message, [key for key, _ in node.buffered[2]],
                node.evictions, evicted, node.buffered_peak, node.buffered_len(2),
                [type(tm.message).__name__ for tm in step.messages])

    ref, got = run(REF), run(PORT)
    assert repr(got) == repr(ref)
    assert got[1] == [(0, 40), (0, 50), (0, 60)]
    assert got[2] == {2: 2} and got[4] == 4
