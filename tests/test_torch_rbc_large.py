"""The port's N > 256 RBC against the JAX package, exactly, on the CPU: the
full-delivery scale path at N = 300 clean and under tamper and framing
faults, and the masked path's GF(2^16) decode at N = 272."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.parallel import rbc as jrbc
from hbbft_tpu_torch.parallel import rbc as trbc

N, F = 300, 99
P = 96  # three proposer chunks of 32
SCALE_KEYS = ("delivered", "fault", "data", "data_receivers", "root",
              "echo_count", "ready_count")


@pytest.fixture(scope="module")
def rbcs():
    return trbc.BatchedRbc(N, F), jrbc.BatchedRbc(N, F)


@pytest.fixture(scope="module")
def framed(rbcs):
    t, j = rbcs
    rng = np.random.default_rng(30)
    values = [rng.integers(0, 256, 40 + 3 * p, dtype=np.uint8).tobytes() for p in range(P)]
    data = trbc.frame_values(values, t.k)
    assert np.array_equal(data, jrbc.frame_values(values, j.k))
    return values, data


def _case(case, data, k):
    """(data, value_tamper or None) of one scale-path run."""
    vt = np.zeros((P, N, data.shape[-1]), dtype=np.uint8)
    if case == "clean":
        return data, None
    if case == "data_shard":  # straggler decode, then stage B
        vt[5, 2, 0] = 0xFF
        vt[40, 0, 3] = 0x01
        vt[40, k - 1, 1] = 0x10
        return data, vt
    if case == "parity_shard":  # data rows intact, stage B still runs
        vt[3, k + 5, 0] = 0x80
        return data, vt
    bad = data.copy()  # framing: a length prefix larger than the payload
    bad[1, 0, :4] = 0xFF
    return bad, None


@pytest.mark.parametrize("case", ["clean", "data_shard", "parity_shard", "framing"])
def test_scale_path_matches_jax(rbcs, framed, case):
    t, j = rbcs
    values, data = framed
    d, vt = _case(case, data, t.k)
    kw_t = {} if vt is None else {"value_tamper": torch.from_numpy(vt)}
    kw_j = {} if vt is None else {"value_tamper": jnp.asarray(vt)}
    got = t.run(torch.from_numpy(d), **kw_t)
    ref = j.run(jnp.asarray(d), **kw_j)
    for key in SCALE_KEYS:
        assert np.array_equal(got[key], np.asarray(ref[key])), key
    assert got["data"].shape == (1, P, t.k, d.shape[-1])
    ec = got["echo_count"][0]
    if case == "framing":
        assert not got["delivered"][:, 1].any() and got["fault"][:, 1].all()
        assert not got["data"][0, 1].any()  # a fault row comes back all-zero
        assert got["delivered"][:, 2:].all() and ec.min() == N
    else:
        assert got["delivered"].all() and not got["fault"].any()
        for p in range(P):
            assert trbc.unframe_value(got["data"][0, p]) == values[p]
    if case == "data_shard":
        assert ec[5] == N - 1 and ec[40] == N - 2 and ec[0] == N


def test_masked_gf16_decode_at_272():
    """Proposer 1 commits an inconsistent codeword (parity row k+3 altered
    before the commit); receiver 5 loses data sources 0..3, so its first k
    survivors lean on that row: it decodes garbage, fails the root
    re-check and faults proposer 1, while receiver 0 delivers both.  The
    decode of those survivors equals JAX's ``_decode_batch``."""
    n, f = 272, 90
    t = trbc.BatchedRbc(n, f)
    assert t.large
    k = t.k
    values = [bytes([40 + p]) * 33 for p in range(2)]
    data = torch.from_numpy(trbc.frame_values(values, k))
    tam = np.zeros((2, n, data.shape[-1]), dtype=np.uint8)
    tam[1, k + 3, 0] = 0xA5
    echo_mask = np.ones((n, n, 2), dtype=bool)
    echo_mask[0:4, 5, :] = False
    out = t.run(data, codeword_tamper=tam, echo_mask=echo_mask, receivers=[0, 5])
    d, fl = out["delivered"].numpy(), out["fault"].numpy()
    assert d[0].all()
    assert trbc.unframe_value(out["data"][0, 1]) == values[1]
    assert d[1, 0] and not d[1, 1]
    assert fl[1, 1] and not fl[1, 0]
    assert trbc.unframe_value(out["data"][1, 0]) == values[0]

    # the decode itself, on the survivors each receiver picks
    shards = t.coder.encode(data) ^ torch.from_numpy(tam)
    use = torch.stack([
        torch.arange(k),  # receiver 0: the data rows
        torch.arange(4, k + 4),  # receiver 5: sources 0..3 lost
    ])[:, None, :].expand(2, 2, k)
    surv = torch.gather(shards[None].expand(2, 2, n, shards.shape[-1]), -2,
                        use[..., None].expand(2, 2, k, shards.shape[-1]))
    got, ok = t._decode_batch(surv, use)
    ref, ok_j = jrbc.BatchedRbc(n, f)._decode_batch(jnp.asarray(surv.numpy()), jnp.asarray(use.numpy()))
    assert np.array_equal(ok.numpy(), np.asarray(ok_j)) and ok.all()
    assert np.array_equal(got.numpy(), np.asarray(ref))
