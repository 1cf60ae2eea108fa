"""The port's full sharded HoneyBadger epoch and its threshold-decrypt hook
on a gloo world of 4 CPU ranks, held exactly against the JAX package:

- one encrypted epoch at N = 16 on a 1-D mesh, the TPKE encrypt on the
  port's device route (the plain windowed ladder on the CPU, its rows
  sharded over the ranks inside ``routed_mesh``), against the JAX
  package's sharded epoch on 4 virtual CPU devices (its native encrypt):
  ciphertext bytes, batch, ABA epochs, ``accepted``, ``delivered`` and
  the ``STATS`` delta;
- ``make_sharded_decrypt`` on the native route and, without the native
  oracle, on the row-sharded device ladder, against the JAX package's hook
  (plaintexts, the rejection of a malformed payload, ``STATS``);
- the row-sharded MSM of ``_MsmCache(mesh=...)`` against the JAX
  package's host sums, and a row count the mesh does not divide running
  unsharded."""

import random

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu.crypto.tc import SecretKeySet as JSecretKeySet
from hbbft_tpu.netinfo import NetworkInfo as JNetworkInfo
from hbbft_tpu.parallel import mesh as jmesh
from hbbft_tpu.parallel.acs import BatchedHoneyBadgerEpoch as JEpoch
from hbbft_tpu_torch import graft_entry

RANKS = 4
N_EPOCH = 16
DECRYPT_SEED, DECRYPT_F = 59, 2
MSM_ROWS = (2, 8)  # 2 rows: not divisible by 4 ranks; 8: two rows a rank


def _decrypt_inputs():
    """The JAX package's key set and ciphertexts (keys from the seed alone,
    as a rank rebuilds them)."""
    rng = random.Random(DECRYPT_SEED)
    sks = JSecretKeySet.random(DECRYPT_F, rng)
    pks = sks.public_keys()
    msgs = [b"payload-%d" % i for i in range(4)]
    payloads = [pks.public_key().encrypt(m, rng).to_bytes() for m in msgs]
    bad = [b"\x00" * len(payloads[0])] + payloads[1:]
    shares = [(i, sks.secret_key_share(i)) for i in range(DECRYPT_F + 1)]
    return pks, shares, msgs, payloads, bad


CONTRIBS = {i: b"tx-%d|" % i + bytes([i & 0xFF]) * (i % 7) for i in range(N_EPOCH)}
_, _, _, PAYLOADS, BAD = _decrypt_inputs()
DECRYPT = {"seed": DECRYPT_SEED, "f": DECRYPT_F, "payloads": PAYLOADS, "bad": BAD}
CASES = [
    ("epoch16", "epoch", {"n": N_EPOCH, "seed": 23, "session": b"mesh-enc-16",
                          "contribs": CONTRIBS}),
    ("decrypt_native", "decrypt", {**DECRYPT, "device_route": False}),
    ("decrypt_device", "decrypt", {**DECRYPT, "device_route": True}),
    ("msm", "msm", {"rows": MSM_ROWS}),
]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def world():
    w = graft_entry.start_world(RANKS, graft_entry.check_rank, (CASES,), device="cpu")
    yield w
    w.close()


def _results(world, name):
    """Case ``name`` of rank 0's results, after checking that every rank
    holds the same; called after the JAX side, which runs meanwhile."""
    per_rank = world.results(timeout_s=300)
    for r in range(1, RANKS):
        assert _same(per_rank[r], per_rank[0]), f"rank {r} differs from rank 0"
    return per_rank[0][name]


def _jax_stats(fn):
    """``fn()``'s result and the reference's STATS delta over it."""
    before = jmesh.stats_snapshot()
    out = fn()
    after = jmesh.stats_snapshot()
    return out, {ph: {k: after[ph][k] - before[ph][k] for k in after[ph]}
                 for ph in sorted(after)}


def _mesh():
    return Mesh(np.array(jax.devices()[:RANKS]), ("nodes",))


def test_sharded_encrypted_epoch_matches_jax(world):
    nets = JNetworkInfo.generate_map(list(range(N_EPOCH)), random.Random(23))
    hb = JEpoch(nets, session_id=b"mesh-enc-16", mesh=_mesh())

    def run():
        payloads = hb.encrypt_phase(dict(CONTRIBS), random.Random(42))
        return (payloads, *hb.run_from_payloads(payloads))

    (payloads, batch, out), stats = _jax_stats(run)
    got = _results(world, "epoch16")
    assert got["stats"] == stats
    assert got["out"]["payloads"] == payloads  # device-route ciphertexts = native
    assert got["out"]["batch"] == batch == CONTRIBS
    assert got["out"]["epochs"] == out["epochs"]
    for key in ("accepted", "delivered"):
        np.testing.assert_array_equal(got["out"][key], np.asarray(out[key]), err_msg=key)


@pytest.mark.parametrize("name", ["decrypt_native", "decrypt_device"])
def test_sharded_decrypt_hook_matches_jax(world, name):
    pks, shares, msgs, payloads, bad = _decrypt_inputs()
    decrypt = jmesh.make_sharded_decrypt(_mesh())

    def run():
        plain = decrypt(pks, payloads, shares)
        with pytest.raises(ValueError):
            decrypt(pks, bad, shares)
        return plain

    plain, stats = _jax_stats(run)
    got = _results(world, name)
    assert got["stats"] == stats
    assert got["out"]["plaintexts"] == plain == msgs
    assert got["out"]["bad_rejected"] is True
    # the device route's one G1 mask ladder (4 ciphertexts, 8 rows) gathered
    assert got["out"]["gathers"] == (["g1"] if name == "decrypt_device" else [])


def test_row_sharded_msm_matches_jax_host_sums(world):
    res = _results(world, "msm")
    # a ladder call moves no mesh counter, sharded or not
    assert all(v == {"collectives": 0, "gather_bytes": 0} for v in res["stats"].values())
    got = res["out"]
    for rows in MSM_ROWS:
        pts = [jc.g1_mul(jc.G1_GEN, 3 + 5 * i) for i in range(rows - 1)]
        sc = [(0x9E3779B97F4A7C15 * (i + 1)) % (1 << 128) | 1 for i in range(rows)]
        acc = None
        for p, s in zip(pts, sc):
            acc = jc.g1_add(acc, jc.g1_mul(p, s))
        assert got[rows]["msm"] == got[rows]["host"] == jc.g1_to_bytes(acc)
        assert got[rows]["sharded"] is (rows % RANKS == 0)
