"""The port's sharded coin-share verification (``make_sharded_coin_verify``:
the G1 and G2 randomized MSMs row-sharded over the mesh) on a gloo world of
4 CPU ranks, held exactly against the JAX package's own hook on 4 of
conftest's virtual CPU devices: True over honest shares, False with one
forged, equal ``STATS`` deltas.  Its own file: the JAX side compiles two
sharded ladders, about 20 s cold on the CPU."""

import random

import jax
import numpy as np
from jax.sharding import Mesh

from hbbft_tpu.crypto.tc import SecretKeySet as JSecretKeySet
from hbbft_tpu.parallel import mesh as jmesh
from hbbft_tpu_torch import graft_entry

RANKS = 4
SPEC = {"seed": 53, "n": 8, "f": 2, "msg": b"round-6 coin"}


def test_sharded_coin_verify_matches_jax():
    world = graft_entry.start_world(
        RANKS, graft_entry.check_rank, ([("coin", "coin", SPEC)],), device="cpu")
    try:
        rng = random.Random(SPEC["seed"])
        sks = JSecretKeySet.random(SPEC["f"], rng)
        pks = sks.public_keys()
        pairs = [(pks.public_key_share(i), sks.secret_key_share(i).sign(SPEC["msg"]))
                 for i in range(SPEC["n"])]
        forged = list(pairs)
        forged[-1] = (pairs[-1][0], sks.secret_key_share(SPEC["n"] - 1).sign(b"not it"))
        verify = jmesh.make_sharded_coin_verify(Mesh(np.array(jax.devices()[:RANKS]), ("nodes",)))
        before = jmesh.stats_snapshot()
        ref = {"honest": verify(pairs, SPEC["msg"], rng),
               "forged": verify(forged, SPEC["msg"], rng)}
        after = jmesh.stats_snapshot()
        stats = {ph: {k: after[ph][k] - before[ph][k] for k in after[ph]} for ph in sorted(after)}
        per_rank = world.results(timeout_s=300)
    finally:
        world.close()
    assert ref == {"honest": True, "forged": False}
    for res in per_rank:
        assert res["coin"]["out"] == ref
        assert res["coin"]["stats"] == stats
