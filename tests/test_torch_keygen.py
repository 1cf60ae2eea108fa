"""The port's network keygen and share folding against the JAX package's,
exactly, on the CPU: every node's threshold share from one native Horner
pass over all points, the Lagrange
coefficients at the points 1 … m in closed form, and a network map whose
nodes share one set of id and key tables."""

import pickle
import random

import pytest

from hbbft_tpu.crypto import tc as jtc
from hbbft_tpu.netinfo import NetworkInfo as JNetworkInfo
from hbbft_tpu_torch.crypto import bls12_381 as c
from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.netinfo import NetworkInfo


@pytest.mark.parametrize("degree", [0, 1, 13, 200])
def test_secret_key_shares_equal_one_evaluation_a_share(degree):
    assert c._native() is not None  # the one-call path, not the per-share one
    sks = tc.SecretKeySet.random(degree, random.Random(degree))
    got = [s.scalar for s in sks.secret_key_shares(300)]
    assert got == [sks.secret_key_share(i).scalar for i in range(300)]


@pytest.mark.parametrize("xs", [[1], [1, 2], list(range(1, 8)), list(range(1, 302)),
                                [2, 3, 4], [1, 3, 4, 9], [5, 2, 7]])
def test_lagrange_coefficients_equal_the_reference(xs):
    """Consecutive points from 1 take the closed form; others the pairwise
    products, as in the reference."""
    assert tc._lagrange_coeffs_at_zero(xs) == jtc._lagrange_coeffs_at_zero(xs)


def test_generate_map_equals_the_reference_and_shares_its_tables():
    ids = list(range(40))
    port = NetworkInfo.generate_map(ids, random.Random(5))
    ref = JNetworkInfo.generate_map(ids, random.Random(5))
    assert port[0].public_key_set().to_bytes() == ref[0].public_key_set().to_bytes()
    for nid in ids:
        assert port[nid].our_id() == nid and port[nid].node_index(nid) == nid
        assert port[nid].secret_key_share().scalar == ref[nid].secret_key_share().scalar
        assert port[nid].secret_key().scalar == ref[nid].secret_key().scalar
        assert port[nid].all_ids() is port[0].all_ids()
    # a node of the map pickles as one built alone from the same keys
    a = port[7]
    alone = NetworkInfo(our_id=7, public_keys=a.public_key_map(),
                        public_key_set=a.public_key_set(),
                        secret_key_share=a.secret_key_share(), secret_key=a.secret_key())
    assert pickle.dumps(a) == pickle.dumps(alone)
