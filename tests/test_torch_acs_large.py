"""The port's ACS past 256 nodes against the JAX package, exactly, on the
CPU: ``BatchedAcs`` at N = 300 (the RBC round on the scale path) in full
and compact mode."""

import numpy as np
import pytest

from hbbft_tpu.parallel.acs import BatchedAcs as JAcs
from hbbft_tpu_torch.parallel.acs import BatchedAcs

N = 300


@pytest.fixture(scope="module")
def acs_pair():
    return BatchedAcs(N, 99, device="cpu"), JAcs(N, 99)


@pytest.mark.parametrize("compact", [False, True])
def test_large_acs_matches_jax(acs_pair, compact):
    rng = np.random.default_rng(50 + compact)
    values = [rng.integers(0, 256, 20 + p % 13, dtype=np.uint8).tobytes() for p in range(N)]
    ref = acs_pair[1].run(values, compact=compact)
    got = acs_pair[0].run(values, compact=compact)
    assert got.keys() == ref.keys()
    for key, want in ref.items():
        assert np.array_equal(got[key], np.asarray(want)), key
    if compact:
        assert got["accepted_row"].all() and got["accepted_agree"]
    else:
        assert got["accepted"].all() and list(got["data_receivers"]) == [0]

