"""Validator removal in object mode at N = 4: the port against the JAX package.

Node 3 voted out of a DynamicHoneyBadger network (the DKG among 0, 1, 2,
the era rotation, an epoch of the new era; ``test_torch_obj_dhb.py``'s
``run_remove``) and out of a QueueingHoneyBadger network with transactions
in flight (``test_torch_obj_qhb.py``'s ``check_change``).  Tolerance:
exact, as in those files.
"""

from test_torch_obj_dhb import run_remove
from test_torch_obj_protocols import PORT, REF
from test_torch_obj_qhb import check_change


def test_remove_validator_matches_reference():
    (ref, ref_era), (got, got_era) = run_remove(REF), run_remove(PORT)
    assert got == ref
    assert got_era == ref_era
    assert {nid: s[:3] for nid, s in got_era.items()} == {
        0: (1, [0, 1, 2], True), 1: (1, [0, 1, 2], True),
        2: (1, [0, 1, 2], True), 3: (1, [0, 1, 2], False)}
    # the removed node's era-1 traffic is all the new era refuses
    assert {f for fl in got["faults"].values() for f in fl} == {(3, "UnknownSender")}


def test_queueing_remove_validator_matches_reference():
    check_change("remove")
