"""One HoneyBadger epoch at n = 4: the port against the JAX package.

The network is made by the JAX package and carried across as plain ints
(``netinfo_map_from_plain``).  The port's device-route encrypt (the plain
field on the CPU) must give the JAX encrypt's ciphertext bytes, and the
port's epoch the JAX epoch's batch and detail arrays."""

import random

import numpy as np
import pytest

from hbbft_tpu.crypto import tc as jtc
from hbbft_tpu.netinfo import NetworkInfo as JNetworkInfo
from hbbft_tpu.parallel.acs import BatchedHoneyBadgerEpoch as JEpoch
from hbbft_tpu_torch.netinfo import NetworkInfo, netinfo_map_from_plain
from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

IDS = list(range(4))


@pytest.fixture(scope="module")
def networks():
    jnets = JNetworkInfo.generate_map(IDS, random.Random(41))
    coeffs = jtc.Poly.interpolate(
        [(jnets[i].node_index(i) + 1, jnets[i].secret_key_share().scalar) for i in IDS]
    ).coeffs
    tnets = netinfo_map_from_plain(
        IDS, coeffs, {i: jnets[i].secret_key().scalar for i in IDS}
    )
    return jnets, tnets


@pytest.fixture(scope="module")
def contributions():
    rng = np.random.default_rng(42)
    return {i: rng.integers(0, 256, 120 + 7 * i, dtype=np.uint8).tobytes() for i in IDS}


def test_network_carries_across(networks):
    jnets, tnets = networks
    assert tnets[0].public_key_set().to_bytes() == jnets[0].public_key_set().to_bytes()
    for i in IDS:
        assert tnets[i].secret_key_share().scalar == jnets[i].secret_key_share().scalar
        assert tnets[i].public_key(i).to_bytes() == jnets[i].public_key(i).to_bytes()
    # the same seed makes the same network on both sides
    again = NetworkInfo.generate_map(IDS, random.Random(41))
    assert again[2].secret_key().scalar == jnets[2].secret_key().scalar


def test_device_encrypt_matches_jax_ciphertexts(networks, contributions):
    jnets, tnets = networks
    ref = JEpoch(jnets).encrypt_phase(contributions, random.Random(43))
    got = BatchedHoneyBadgerEpoch(
        tnets, device="cpu", encrypt_backend="device"
    ).encrypt_phase(contributions, random.Random(43))
    assert got == ref


def test_epoch_run_matches_jax(networks, contributions):
    jnets, tnets = networks
    jb, jd = JEpoch(jnets).run(contributions, random.Random(44))
    tb, td = BatchedHoneyBadgerEpoch(
        tnets, device="cpu", encrypt_backend="native"
    ).run(contributions, random.Random(44))
    assert tb == jb == contributions
    for key in ("accepted", "delivered", "data", "data_receivers", "rbc_fault"):
        assert np.array_equal(td[key], np.asarray(jd[key])), key
    assert td["epochs"] == jd["epochs"]


def test_compact_epoch_matches_jax(networks, contributions):
    jnets, tnets = networks
    jb, jd = JEpoch(jnets, compact=True).run(contributions, random.Random(45))
    tb, td = BatchedHoneyBadgerEpoch(
        tnets, device="cpu", compact=True, encrypt_backend="native"
    ).run(contributions, random.Random(45))
    assert tb == jb == contributions
    for key in ("accepted_row", "data_sel"):
        assert np.array_equal(td[key], np.asarray(jd[key])), key
    for key in ("accepted_agree", "delivered_ok", "epochs"):
        assert td[key] == jd[key], key


def test_acs_under_masks_matches_jax():
    """ACS with proposer 3's Values withheld from all but one node and
    random Echo/Ready drops: the same accepted set and detail arrays."""
    from hbbft_tpu.parallel.acs import BatchedAcs as JAcs
    from hbbft_tpu_torch.parallel.acs import BatchedAcs

    rng = np.random.default_rng(46)
    values = [rng.integers(0, 256, 30 + i, dtype=np.uint8).tobytes() for i in IDS]
    vm = np.ones((4, 4), dtype=bool)
    vm[3, :3] = False
    em = rng.random((4, 4, 4)) > 0.2
    rm = rng.random((4, 4, 4)) > 0.2
    ref = JAcs(4, 1).run(values, value_mask=vm, echo_mask=em, ready_mask=rm)
    got = BatchedAcs(4, 1, device="cpu").run(
        values, value_mask=vm, echo_mask=em, ready_mask=rm
    )
    for key in ("accepted", "delivered", "data", "data_receivers", "rbc_fault"):
        assert np.array_equal(got[key], np.asarray(ref[key])), key
    assert got["epochs"] == ref["epochs"]
