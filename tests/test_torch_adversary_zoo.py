"""The network-level adversary zoo: the port against the JAX package.

``TargetedDelayAdversary``, ``CensorshipAdversary``, ``EclipseAdversary``,
``VoteStormAdversary``, ``FloodAdversary``, ``SpoofReplayAdversary``,
``FutureEpochSpamAdversary`` and ``CrashAtEpochAdversary``, each built as the
reference's chaos campaign builds it (``chaos/campaign.py``
``make_adversary``, seeded), against the campaign's simulator stack (QHB over
DHB, batches of 4, eight transactions) at N = 4 on each package's
``VirtualNet`` with an event log and a cost model.  The flood and spam cells
mark the last node faulty, as the campaign does.  Eclipse, crash and
censorship also run under a shaped net, where the eclipse's heal reads
``quiescent`` (the live queue and the shaper's held set both empty).

Tolerance: exact.  Every node's ledger and outputs (``batch_bytes``), fault
log, crank count, ``EventLog`` counts and bytes, virtual time, the net's
``adversary_filtered`` and the adversary's own counters are equal.
"""

import random

import pytest

from test_torch_obj_protocols import PORT, REF, infos
from test_torch_sender_queue import stack_summary, x


def make(p, name, n, seed):
    a = x(p).adv
    if name == "targeted-delay":
        return a.TargetedDelayAdversary([0], seed=seed)
    if name == "censor-ready":
        return a.CensorshipAdversary(msg_types=("ReadyMsg",), dests=(1,), seed=seed)
    if name == "eclipse":
        return a.EclipseAdversary(victim=n - 1, heal_crank=1500 + (seed % 4) * 700)
    if name == "vote-storm":
        return a.VoteStormAdversary(seed=seed, max_waves=3)
    if name == "flood":
        return a.FloodAdversary(flooder=n - 1, seed=seed)
    if name == "spoof-replay":
        return a.SpoofReplayAdversary(victim=0, seed=seed)
    if name == "future-spam":
        return a.FutureEpochSpamAdversary(spammer=n - 1, seed=seed)
    if name == "crash":
        return a.CrashAtEpochAdversary(victim=n - 1, after_batches=1 + seed % 2)
    raise ValueError(name)


#: cranks a cell may run (the reordering adversaries keep the keep-alive
#: epochs going; the spam cells need the room to drain their budget)
LIMITS = {"targeted-delay": 3000, "future-spam": 9000}


def stack(p, nets, nid):
    b = (p.dhb.DynamicHoneyBadger.builder(nets[nid], nets[nid].secret_key())
         .rng(random.Random(100 + nid)))
    if p is PORT:
        b = b.device("cpu")
    dhb = b.encryption_schedule(p.hb.EncryptionSchedule.never()).build()
    return p.qhb.QueueingHoneyBadger(dhb, batch_size=4, rng=random.Random(500 + nid))


def run_cell(p, name, n=4, seed=1, shape=None):
    nets = infos(p, n)
    log = p.sim.EventLog()
    faulty = (n - 1,) if name in ("flood", "future-spam") else ()
    adv = make(p, name, n, seed)
    b = (p.sim.NetBuilder(list(range(n))).adversary(adv).faulty(faulty).trace(log)
         .cost_model(p.sim.CostModel()))
    if shape is not None:
        b = b.shape(x(p).link.preset_shape(shape, n).scaled(1e-3), seed=seed)
    net = b.using_step(lambda nid: stack(p, nets, nid))
    for i in range(8):
        net.send_input(i % n, p.qhb.TxInput(b"chaos-%04d" % i))
    limit = LIMITS.get(name, 20_000)
    while net.cranks < limit and net.crank() is not None:
        pass
    out = stack_summary(p, net, log)
    out["adversary"] = {k: v for k, v in vars(adv).items()
                        if isinstance(v, (bool, int, float))}
    out["ledgers"] = {nid: [tx for o in net.nodes[nid].outputs if isinstance(o, p.qhb.QhbBatch)
                            for _, txs in o.contributions for tx in txs]
                      for nid in net.node_ids()}
    out["eras"] = {nid: [o.era for o in net.nodes[nid].outputs] for nid in net.node_ids()}
    out["quiescent"] = net.quiescent
    return out


NAMES = ("targeted-delay", "censor-ready", "eclipse", "vote-storm", "flood",
         "spoof-replay", "future-spam", "crash")


@pytest.mark.parametrize("name", NAMES)
def test_adversary_matches_reference(name):
    ref, got = run_cell(REF, name), run_cell(PORT, name)
    assert got == ref
    counters = got["adversary"]
    if name in ("flood", "spoof-replay", "future-spam"):
        assert counters["injected"] == counters["budget"] > 0
    if name == "censor-ready":
        assert counters["censored"] == got["filtered"] > 0
    if name == "eclipse":
        assert counters["healed"]
    if name == "crash":
        assert counters["crashed"] and counters["dropped"] == got["filtered"] > 0
    if name == "vote-storm":
        assert counters["waves"] == 3 and counters["injected"] > 0
        assert max(got["eras"][0]) >= 1  # a wave rotated the era
    # the correct nodes agree: each ledger is a prefix of the longest, and
    # a cell that drained committed every transaction
    correct = [nid for nid in range(4) if not (name in ("flood", "future-spam") and nid == 3)]
    ledgers = [got["ledgers"][nid] for nid in correct]
    longest = max(ledgers, key=len)
    assert all(led == longest[:len(led)] for led in ledgers)
    assert set(longest) <= {b"chaos-%04d" % i for i in range(8)}
    if got["quiescent"] and name not in ("crash", "censor-ready"):
        assert set(longest) == {b"chaos-%04d" % i for i in range(8)}


@pytest.mark.parametrize("name", ("eclipse", "crash", "censor-ready"))
def test_adversary_under_shaping_matches_reference(name):
    ref = run_cell(REF, name, shape="wan-100ms")
    got = run_cell(PORT, name, shape="wan-100ms")
    assert got == ref and got["shaper"]["shaped"] > 0


def test_adversaries_at_seven_match_reference():
    for name in ("crash", "eclipse"):
        assert run_cell(PORT, name, n=7, seed=2) == run_cell(REF, name, n=7, seed=2)
