"""Kernel 1's plain version (``hbbft_tpu_torch.ops.fp_lazy.mul_lazy_cols``)
and the port's lazy field against the JAX package: digit-exact with
``pallas_fp.mul_lazy_cols`` and the Pallas kernel in interpret mode,
residue-equal with ``fp381.fp_mul_lazy``; the lazy add/sub/neg and Fp2
products digit-exact with ``fp381`` on transposed inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hbbft_tpu.ops import fp381 as JF
from hbbft_tpu.ops import pallas_fp as PF
from hbbft_tpu_torch.ops import fp381 as TF
from hbbft_tpu_torch.ops import fp_lazy

R = 64


def _operands(seed):
    """Lazy-invariant digit columns (NL, R), extreme digits included."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, (1 << 13) + 1, (TF.NL, R)).astype(np.int32)
    b = rng.integers(0, (1 << 13) + 1, (TF.NL, R)).astype(np.int32)
    a[:, 0] = 1 << 13
    b[:, 0] = 1 << 13
    a[:, 1] = 0
    return a, b


def test_constants_match_jax():
    assert np.array_equal(TF._FOLD_HI, JF._FOLD_HI)
    assert np.array_equal(TF._SUBC_LIMBS, JF._SUBC_LIMBS)


def test_plain_mul_digit_exact_vs_pallas_reference_and_interpret():
    a, b = _operands(1)
    got = fp_lazy.mul_lazy_cols(
        torch.from_numpy(a), torch.from_numpy(b), TF.consts("cpu").fold
    ).numpy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref = np.asarray(jax.jit(PF.mul_lazy_cols)(ja, jb, jnp.asarray(PF._FOLD_HI)))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.asarray(PF.fp_mul_lazy_pallas(ja, jb, interpret=True)))
    # the CPU side of the wrapper is the plain version
    assert np.array_equal(fp_lazy.fp_mul_lazy(torch.from_numpy(a), torch.from_numpy(b)).numpy(), got)
    assert got.min() >= 0 and got.max() <= 1 << 13


def test_mul_residue_equal_to_fp381_and_host():
    a, b = _operands(2)
    got = fp_lazy.fp_mul_lazy(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax.jit(JF.fp_mul_lazy)(jnp.asarray(a.T), jnp.asarray(b.T)))
    xs, ys = JF.limbs_to_ints_batch(a.T), JF.limbs_to_ints_batch(b.T)
    for g, r, x, y in zip(TF.limbs_to_ints_batch(got.T), JF.limbs_to_ints_batch(ref), xs, ys):
        assert g % JF.P == r % JF.P == x * y % JF.P


def test_lazy_add_sub_neg_digit_exact():
    a, b = _operands(3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    refs = jax.jit(  # one compile for the three
        lambda x, y: (JF.fp_add_lazy(x, y), JF.fp_sub_lazy(x, y), JF.fp_neg_lazy(x))
    )(jnp.asarray(a.T), jnp.asarray(b.T))
    gots = (TF.fp_add_lazy(ta, tb), TF.fp_sub_lazy(ta, tb), TF.fp_neg_lazy(ta))
    for got, ref in zip(gots, refs):
        assert np.array_equal(got.numpy(), np.asarray(ref).T)


def test_fp2_mul_and_sqr_digit_exact():
    a, b = _operands(4)
    c, d = _operands(5)
    ta = TF.fp2_pack(torch.from_numpy(a), torch.from_numpy(b))
    tb = TF.fp2_pack(torch.from_numpy(c), torch.from_numpy(d))
    ja = (jnp.asarray(a.T), jnp.asarray(b.T))
    jb = (jnp.asarray(c.T), jnp.asarray(d.T))
    for got, ref in [
        (TF.fp2_mul_lazy(ta, tb), jax.jit(JF.fp2_mul_lazy)(ja, jb)),
        (TF.fp2_sqr_lazy(ta), jax.jit(JF.fp2_sqr_lazy)(ja)),
    ]:
        for g, r in zip(TF.fp2_parts(got), ref):
            assert np.array_equal(g.numpy(), np.asarray(r).T)


def test_host_limb_converters_match_jax():
    xs = [0, 1, JF.P - 1, (1 << 390) - 1, 12345678901234567890]
    assert np.array_equal(TF.ints_to_limbs_batch(xs), JF.ints_to_limbs_batch(xs))
    rows = JF.ints_to_limbs_batch(xs)
    assert TF.limbs_to_ints_batch(rows) == JF.limbs_to_ints_batch(rows) == xs
    assert np.array_equal(TF.fp2_to_limbs((5, JF.P + 7)), JF.fp2_to_limbs((5, JF.P + 7)))
