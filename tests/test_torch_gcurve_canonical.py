"""The port's complete curve arithmetic over the canonical field, on the CPU.

``gcurve.point_add`` (complete), ``scalar_mul`` and ``msm`` over
``FP_OPS``/``FP2_OPS`` value-exact against the JAX package's host curve
(``hbbft_tpu.crypto.bls12_381``), with ∞ operands, P = Q and P = −Q, in
G1 and G2.  (The field itself is held digit-exact against the reference in
``test_torch_fp_canonical.py``.)"""

import random

import pytest
import torch

from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu_torch.ops import fp381 as F
from hbbft_tpu_torch.ops import gcurve as G


def _group(group):
    if group == "g1":
        return (jc.g1_mul, jc.G1_GEN, jc.g1_add, jc.g1_neg, jc.g1_eq,
                G.g1_to_device, G.g1_from_device_batch, G.FP_OPS)
    return (jc.g2_mul, jc.G2_GEN, jc.g2_add, jc.g2_neg, jc.g2_eq,
            G.g2_to_device, G.g2_from_device_batch, G.FP2_OPS)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_complete(group):
    """P + Q, P + P, P + (−P), ∞ + Q, P + ∞, ∞ + ∞ in one batch."""
    mul, gen, add, neg, eq, to_dev, from_dev, ops = _group(group)
    rng = random.Random(31 if group == "g1" else 32)
    p, q = (mul(gen, rng.randrange(1, jc.R)) for _ in range(2))
    lhs = [p, p, p, None, p, None]
    rhs = [q, p, neg(p), q, None, None]
    got = from_dev(G.point_add(ops, to_dev(lhs, "cpu"), to_dev(rhs, "cpu")))
    for g, a, b in zip(got, lhs, rhs):
        assert eq(g, add(a, b))
    assert got[2] is None and got[5] is None


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_and_msm_match_host(group):
    """8-bit scalars over 4 rows: a zero scalar, an ∞ base, and two rows on
    the same base (the msm's tree then adds P-multiples that can meet as
    P = Q); msm over the same rows against the host sum."""
    mul, gen, add, neg, eq, to_dev, from_dev, ops = _group(group)
    rng = random.Random(33 if group == "g1" else 34)
    p = mul(gen, rng.randrange(1, jc.R))
    pts = [p, mul(gen, rng.randrange(1, jc.R)), None, p]
    sc = [0xA5, 0, 0x7F, 0xA5]
    pt = to_dev(pts, "cpu")
    bits = torch.from_numpy(F.bits_batch(sc, 8))
    got = from_dev(G.scalar_mul(ops, pt, bits))
    want = [None if x is None else mul(x, s) for x, s in zip(pts, sc)]
    for g, w in zip(got, want):
        assert eq(g, w)
    total = None
    for w in want:
        total = add(total, w)
    (m,) = from_dev(G.msm(ops, pt, bits))
    assert eq(m, total)
    # P + (−P) inside the tree: the sum is ∞
    (z,) = from_dev(G.msm(ops, to_dev([p, neg(p)], "cpu"), torch.from_numpy(F.bits_batch([5, 5], 4))))
    assert z is None
