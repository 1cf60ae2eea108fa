"""One HoneyBadger epoch past 256 nodes, the port against the JAX package
on the CPU: N = 260 with the native encrypt on both sides, the same batch
and accepted set (the device encrypt route at this N is checked on the
card)."""

import random

import numpy as np

from hbbft_tpu.crypto import tc as jtc
from hbbft_tpu.netinfo import NetworkInfo as JNetworkInfo
from hbbft_tpu.parallel.acs import BatchedHoneyBadgerEpoch as JEpoch
from hbbft_tpu_torch.netinfo import netinfo_map_from_plain
from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch


def test_epoch_260_matches_jax(monkeypatch):
    ids = list(range(260))
    jnets = JNetworkInfo.generate_map(ids, random.Random(61))
    coeffs = jtc.Poly.interpolate(
        [(jnets[i].node_index(i) + 1, jnets[i].secret_key_share().scalar) for i in ids[:87]]
    ).coeffs
    tnets = netinfo_map_from_plain(ids, coeffs, {i: jnets[i].secret_key().scalar for i in ids})
    rng = np.random.default_rng(62)
    contribs = {i: rng.integers(0, 256, 30 + i % 9, dtype=np.uint8).tobytes() for i in ids}
    monkeypatch.setenv("HBBFT_ENCRYPT_BACKEND", "native")
    jb, jd = JEpoch(jnets).run(contribs, random.Random(63))
    tb, td = BatchedHoneyBadgerEpoch(
        tnets, device="cpu", encrypt_backend="native"
    ).run(contribs, random.Random(63))
    assert tb == jb == contribs
    assert np.array_equal(td["accepted"][0], np.asarray(jd["accepted"])[0])
    assert td["accepted"].all() and td["epochs"] == jd["epochs"]
