"""The port's sharded protocol rounds (``hbbft_tpu_torch.parallel.mesh``) on
a gloo world of 4 CPU ranks, held exactly against the JAX package's own
sharded functions on 4 of conftest's virtual CPU devices: the RBC round on
a 1-D mesh with masks and both tampers (a rank's receivers decoded at
once, and one a call) and on a 2 × 2 ``("dcn", "ici")`` mesh, the ABA
step (full delivery and masked), and the collective accounting
(``STATS``) of each.  An N = 9 era of the dynamic driver on the 4 ranks
runs unsharded, as in the reference.  (The large-N round, the epoch and
the crypto hooks are in ``test_torch_mesh_*.py``: each file stays under
30 s with the JAX side's compiles cold.)

One world serves the module: it starts with the first test and runs every
case while the JAX side computes; each rank's results must equal every
other rank's (the results are replicated)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hbbft_tpu.parallel import mesh as jmesh
from hbbft_tpu.parallel.aba import BatchedAba as JAba
from hbbft_tpu.parallel.rbc import BatchedRbc as JRbc
from hbbft_tpu.parallel.rbc import frame_values
from hbbft_tpu_torch import graft_entry
from hbbft_tpu_torch.parallel.rbc import BatchedRbc

RANKS = 4
RBC_KEYS = ("delivered", "fault", "data", "data_receivers", "root", "echo_count",
            "ready_count")


def _rbc_masked_spec():
    n, f = 8, 2
    k = n - 2 * f
    data = frame_values([bytes([p + 1]) * 10 for p in range(n)], k)
    rng = np.random.default_rng(9)
    em = ~(rng.random((n, n, n)) < 0.15)
    rm = ~(rng.random((n, n, n)) < 0.1)
    vm = ~(rng.random((n, n)) < 0.1)
    cw = np.zeros((n, n, data.shape[-1]), dtype=np.uint8)
    cw[4, 1, 0] = 0x33  # an inconsistent codeword, committed
    vt = np.zeros_like(cw)
    vt[2, 5, 0] = 0x77  # proposer 2's Value to node 5 altered in flight
    kwargs = {"codeword_tamper": cw, "value_tamper": vt, "value_mask": vm,
              "echo_mask": em, "ready_mask": rm}
    return {"n": n, "f": f, "mesh": "1d", "data": data, "kwargs": kwargs}


def _rbc_2d_spec():
    n, f = 8, 2
    data = frame_values([bytes([p + 3]) * 7 for p in range(n)], n - 2 * f)
    return {"n": n, "f": f, "mesh": "2d", "data": data, "kwargs": {}}


def _aba_spec(seed: int, epochs: int, masked: bool):
    n, f = 8, 2
    rng = np.random.default_rng(seed)
    est = rng.random((n, n)) < 0.5
    coins, masks = [], []
    for _ in range(epochs):
        coins.append(rng.random((n,)) < 0.5)
        masks.append({name: ~(rng.random((n, n, n)) < 0.2)
                      for name in ("bval_mask", "aux_mask", "conf_mask")} if masked else {})
    return {"n": n, "f": f, "est": est, "coins": coins, "masks": masks}


def _rbc_chunked_spec():
    """``rbc_masked`` with a rank decoding one receiver a call."""
    spec = _rbc_masked_spec()
    P, k, B = spec["data"].shape
    return {**spec, "receiver_chunk_bytes": P * spec["n"] * B}


CASES = [
    ("rbc_masked", "rbc", _rbc_masked_spec()),
    ("rbc_masked_chunked", "rbc", _rbc_chunked_spec()),
    ("rbc_2d", "rbc", _rbc_2d_spec()),
    ("aba_full", "aba", _aba_spec(3, 9, False)),
    ("aba_masked", "aba", _aba_spec(5, 12, True)),
    ("dhb_n9", "dhb_fallback", {"n": 9}),
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


@pytest.fixture(scope="module")
def meshes(world):
    devs = np.array(jax.devices()[:RANKS])
    return {"1d": Mesh(devs, ("nodes",)), "2d": Mesh(devs.reshape(2, 2), ("dcn", "ici"))}


def _jax_stats(fn):
    """``fn()``'s result and the reference's STATS delta over it."""
    before = jmesh.stats_snapshot()
    out = fn()
    after = jmesh.stats_snapshot()
    return out, {ph: {k: after[ph][k] - before[ph][k] for k in after[ph]}
                 for ph in sorted(after)}


def _spec(name):
    return next(spec for n, _, spec in CASES if n == name)


@pytest.mark.parametrize("name", ["rbc_masked", "rbc_masked_chunked", "rbc_2d"])
def test_sharded_rbc_matches_jax_and_one_device(world, meshes, name):
    spec = _spec(name)
    rbc = JRbc(spec["n"], spec["f"])
    kw = {k: jnp.asarray(v) for k, v in spec["kwargs"].items()}
    ref, stats = _jax_stats(lambda: jmesh.sharded_rbc_run(
        rbc, meshes[spec["mesh"]], jnp.asarray(spec["data"]), **kw))
    got = _results(world, name)
    assert got["stats"] == stats
    for key in RBC_KEYS:
        np.testing.assert_array_equal(got["out"][key], np.asarray(ref[key]), err_msg=key)
    # the port's one-device masked round (all-ones masks where none given)
    n = spec["n"]
    one_kw = {"value_mask": np.ones((n, n), bool), "echo_mask": np.ones((n, n, n), bool),
              "ready_mask": np.ones((n, n, n), bool), **spec["kwargs"]}
    single = BatchedRbc(n, spec["f"]).run(
        torch.from_numpy(spec["data"]),
        **{k: torch.from_numpy(v) for k, v in one_kw.items()})
    for key in RBC_KEYS:
        np.testing.assert_array_equal(got["out"][key], single[key].numpy(), err_msg=key)
    assert got["out"]["delivered"].any()
    if name != "rbc_2d":  # the committed inconsistent codeword is caught
        assert got["out"]["fault"][:, 4].any()


@pytest.mark.parametrize("name", ["aba_full", "aba_masked"])
def test_sharded_aba_matches_jax(world, meshes, name):
    spec = _spec(name)
    aba = JAba(spec["n"], spec["f"])
    step = jmesh.make_sharded_aba_step(aba, meshes["1d"])

    def run():
        st = aba.init_state(jnp.asarray(spec["est"]))
        states = []
        for coins, masks in zip(spec["coins"], spec["masks"]):
            st = step(st, jnp.asarray(coins), **{k: jnp.asarray(m) for k, m in masks.items()})
            states.append({k: np.asarray(st[k]) for k in ("est", "decided", "decision")})
        return states

    ref, stats = _jax_stats(run)
    got = _results(world, name)
    assert got["stats"] == stats
    for e, (g, r) in enumerate(zip(got["out"], ref)):
        for key in r:
            np.testing.assert_array_equal(g[key], r[key], err_msg=f"{key}@{e}")
    if name == "aba_full":
        assert got["out"][-1]["decided"].all()


def test_era_the_mesh_does_not_divide_runs_unsharded(world, meshes):
    """N = 9 on 4 ranks: the era's epoch has no mesh, its batch is whole,
    and no mesh counter moved — the reference's own fallback."""
    from hbbft_tpu.netinfo import NetworkInfo as JNetworkInfo
    from hbbft_tpu.parallel.dhb import BatchedDynamicHoneyBadger as JDhb

    ref = JDhb(JNetworkInfo.generate_map(list(range(9)), random.Random(77)),
               session_id=b"mesh-dhb", rng=random.Random(5), mesh=meshes["1d"])
    assert ref.hb.acs.mesh is None
    got = _results(world, "dhb_n9")
    assert got["out"]["epoch_mesh"] is False and got["out"]["acs_mesh"] is False
    assert got["out"]["contributions"] == {nid: b"m1-%d" % nid for nid in range(9)}
    assert all(v == {"collectives": 0, "gather_bytes": 0} for v in got["stats"].values())
