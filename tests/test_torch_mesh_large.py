"""The port's large-N sharded RBC round (``make_sharded_rbc_large_run``:
the GF(2^16) scale path with its proposer axis sharded) on a gloo world of
4 CPU ranks, held exactly against the JAX package's own on 4 of conftest's
virtual CPU devices, clean and with both tampers (the straggler decode and
the sharded re-check stage), with equal ``STATS`` deltas.

N = 272, the first N past 256 whose 68 proposers a rank run in chunks of
4: at N = 260 a rank's 65 run one at a time, four times the plain SHA3
calls on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from hbbft_tpu.parallel import mesh as jmesh
from hbbft_tpu.parallel.rbc import BatchedRbc as JRbc
from hbbft_tpu.parallel.rbc import frame_values
from hbbft_tpu_torch import graft_entry

RANKS = 4
RBC_KEYS = ("delivered", "fault", "data", "data_receivers", "root", "echo_count",
            "ready_count")


def _large_spec(tampered: bool):
    n, f = 272, 90
    k = n - 2 * f
    data = frame_values([b"v%d" % i for i in range(n)], k)
    kwargs = {}
    if tampered:
        cw = np.zeros((n, n, data.shape[-1]), dtype=np.uint8)
        cw[3, k:, :] = 0x5A  # proposer 3: every parity shard, committed
        vt = np.zeros_like(cw)
        vt[5, 0, :] = 0xA5  # a data shard after the commit: straggler decode
        vt[7, : n - f + 1, :] = 0xA5  # too few valid shards: not delivered
        kwargs = {"codeword_tamper": cw, "value_tamper": vt}
    return {"n": n, "f": f, "mesh": "1d", "data": data, "kwargs": kwargs}


CASES = [
    ("large_clean", "rbc", _large_spec(False)),
    ("large_tampered", "rbc", _large_spec(True)),
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


@pytest.mark.parametrize("name", ["large_clean", "large_tampered"])
def test_sharded_large_rbc_matches_jax(world, name):
    spec = next(s for n, _, s in CASES if n == name)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("nodes",))
    run = jmesh.make_sharded_rbc_large_run(JRbc(spec["n"], spec["f"]), mesh)
    kw = {k: jnp.asarray(v) for k, v in spec["kwargs"].items()}
    ref, stats = _jax_stats(lambda: run(jnp.asarray(spec["data"]), **kw))
    got = _results(world, name)
    assert got["stats"] == stats
    for key in RBC_KEYS:
        np.testing.assert_array_equal(got["out"][key], np.asarray(ref[key]), err_msg=key)
    delivered = got["out"]["delivered"][0]
    if name == "large_clean":
        assert delivered.all()
    else:
        assert delivered[3] and delivered[5] and not delivered[7]
