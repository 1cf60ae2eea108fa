"""The port's batched RBC and ABA against the JAX package, exactly: every
RBC output key under full delivery, a masked schedule and a tamper
schedule; the ABA state dict after every epoch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.parallel import aba as jaba
from hbbft_tpu.parallel import rbc as jrbc
from hbbft_tpu_torch.parallel import aba as taba
from hbbft_tpu_torch.parallel import rbc as trbc

RBC_KEYS = ("delivered", "fault", "data", "data_receivers", "root",
            "echo_count", "ready_count")


def _schedule(case, n, P, B, rng):
    """Keyword arguments of one RBC run, as numpy arrays."""
    if case == "full":
        return {}
    if case == "masked":
        return {
            "value_mask": rng.random((P, n)) > 0.15,
            "echo_mask": rng.random((n, n, P)) > 0.25,
            "ready_mask": rng.random((n, n, P)) > 0.25,
        }
    ct = np.zeros((P, n, B), dtype=np.uint8)
    ct[1, n - 1, 0] = 0x5A  # inconsistent codeword under a valid commit
    vt = np.zeros((P, n, B), dtype=np.uint8)
    vt[2, 0, 1] = 0x01  # shard altered after the commit: invalid proof
    vt[2, n // 2, 1] = 0x80
    return {"codeword_tamper": ct, "value_tamper": vt}


@pytest.mark.parametrize("n,f", [(4, 1), (16, 5)])
@pytest.mark.parametrize("case", ["full", "masked", "tamper"])
def test_rbc_run_matches_jax(n, f, case):
    rng = np.random.default_rng(n * 10 + len(case))
    values = [rng.integers(0, 256, 20 + 3 * p, dtype=np.uint8).tobytes() for p in range(n)]
    t, j = trbc.BatchedRbc(n, f), jrbc.BatchedRbc(n, f)
    data = trbc.frame_values(values, t.k)
    assert np.array_equal(data, jrbc.frame_values(values, j.k))
    kw = _schedule(case, n, n, data.shape[-1], rng)
    got = t.run(torch.from_numpy(data), **kw)
    ref = jax.jit(j.run)(jnp.asarray(data), **{k: jnp.asarray(v) for k, v in kw.items()})
    for key in RBC_KEYS:
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
    delivered = got["delivered"].numpy()
    if case == "tamper":  # the two altered shards fail their proofs
        assert (got["echo_count"].numpy()[:, 2] == n - 2).all()
    if case == "full":
        assert delivered.all()
        for p in range(n):
            assert trbc.unframe_value(got["data"][0, p]) == values[p]


@pytest.mark.parametrize("n,f", [(4, 1), (16, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_aba_state_matches_jax_every_epoch(n, f, masked):
    rng = np.random.default_rng(n + 100 * masked)
    P = n
    est = rng.random((n, P)) > 0.5
    t, j = taba.BatchedAba(n, f), jaba.BatchedAba(n, f)
    ts, js = t.init_state(torch.from_numpy(est)), j.init_state(jnp.asarray(est))
    jstep = jax.jit(j.epoch_step)
    for _ in range(7):
        coins = rng.random(P) > 0.5
        kw = {}
        if masked:
            kw = {m: rng.random((n, n, P)) > 0.2
                  for m in ("bval_mask", "aux_mask", "conf_mask")}
        ts = t.epoch_step(ts, torch.from_numpy(coins), **{k: torch.from_numpy(v) for k, v in kw.items()})
        js = jstep(js, jnp.asarray(coins), **{k: jnp.asarray(v) for k, v in kw.items()})
        for key in ("est", "decided", "decision", "epoch"):
            assert np.array_equal(ts[key].numpy(), np.asarray(js[key])), key


def test_round_model_horizons_match_jax():
    assert (taba.SBV_ROUNDS_FULL, taba.SBV_INF_FULL) == (jaba.SBV_ROUNDS_FULL, jaba.SBV_INF_FULL)
    for n in (4, 16, 64):
        assert taba.sbv_rounds_masked(n) == jaba.sbv_rounds_masked(n)
        assert taba.sbv_inf_masked(n) == jaba.sbv_inf_masked(n)
