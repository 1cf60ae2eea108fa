"""The port's GLV/GLS-split lazy ladders (``g1_mul_batch``/
``g2_mul_batch`` over ``gcurve.scalar_mul_lazy``, plain field on the CPU)
against the JAX package's host curve, exactly, at B = 4."""

import random

from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu_torch.crypto import batch as tb
from hbbft_tpu_torch.ops import gcurve as tg


def _scalars(rng):
    # full-range scalars, plus 0 and r−1 at the edges of the split
    return [rng.randrange(jc.R), 0, jc.R - 1, rng.randrange(jc.R)]


def test_g1_mul_batch_matches_host():
    rng = random.Random(21)
    pts = [jc.g1_mul(jc.G1_GEN, rng.randrange(1, jc.R)) for _ in range(3)] + [None]
    sc = _scalars(rng)
    got = tb.cache_for("cpu").g1_mul_batch(pts, sc)
    for g, p, s in zip(got, pts, sc):
        assert jc.g1_eq(g, jc.g1_mul(p, s))


def test_g2_mul_batch_matches_host():
    rng = random.Random(22)
    pts = [None] + [jc.g2_mul(jc.G2_GEN, rng.randrange(1, jc.R)) for _ in range(3)]
    sc = _scalars(rng)
    got = tb.cache_for("cpu").g2_mul_batch(pts, sc)
    for g, p, s in zip(got, pts, sc):
        assert jc.g2_eq(g, jc.g2_mul(p, s))


def test_device_point_roundtrip():
    rng = random.Random(23)
    g1 = [jc.g1_mul(jc.G1_GEN, rng.randrange(1, jc.R)), None]
    back = tg.g1_from_device_batch(tg.g1_to_device(g1, "cpu"))
    assert jc.g1_eq(back[0], g1[0]) and back[1] is None
    g2 = [jc.g2_mul(jc.G2_GEN, rng.randrange(1, jc.R)), None]
    back = tg.g2_from_device_batch(tg.g2_to_device(g2, "cpu"))
    assert jc.g2_eq(back[0], g2[0]) and back[1] is None
