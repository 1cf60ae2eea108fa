"""The port's canonical field and its complete curve arithmetic, on the CPU.

The canonical Fp/Fp2 ops of ``hbbft_tpu_torch/ops/fp381.py`` digit-exact
against the JAX package's ``hbbft_tpu.ops.fp381`` (each Fp op jitted alone;
the Fp2 ops, which compose them, run eagerly), on
random residues and on edge values: 0, 1, p − 1 and all-ones limbs
(2^390 − 1, outside [0, p)).  The curve arithmetic over this field is
``test_torch_gcurve_canonical.py``'s."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hbbft_tpu.ops import fp381 as JF
from hbbft_tpu_torch.ops import fp381 as F

P = F.P


def _rows(seed):
    """(B, NL) limb rows: edge values, then random residues."""
    rng = random.Random(seed)
    vals = [0, 1, P - 1, P - 2, 2] + [rng.randrange(P) for _ in range(7)]
    rows = F.ints_to_limbs_batch(vals)
    return np.concatenate([rows, np.full((2, F.NL), F.MASK, np.int32)])


def _cols(rows):
    return torch.from_numpy(np.ascontiguousarray(rows.T))


def test_fp_ops_digit_exact_with_reference():
    a = _rows(1)
    b = np.roll(a, 3, axis=0)
    b[0] = a[0]  # one equal pair for fp_eq
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref = [jax.jit(JF.fp_add)(ja, jb), jax.jit(JF.fp_sub)(ja, jb), jax.jit(JF.fp_mul)(ja, jb),
           jax.jit(JF.fp_sqr)(ja), jax.jit(JF.fp_neg)(ja), jax.jit(JF.fp_is_zero)(ja),
           jax.jit(JF.fp_eq)(ja, jb)]
    ta, tb = _cols(a), _cols(b)
    got = (F.fp_add(ta, tb), F.fp_sub(ta, tb), F.fp_mul(ta, tb), F.fp_sqr(ta),
           F.fp_neg(ta), F.fp_is_zero(ta), F.fp_eq(ta, tb))
    for name, r, g in zip(("add", "sub", "mul", "sqr", "neg"), ref, got):
        assert np.array_equal(np.asarray(r), g.numpy().T), name
    assert np.asarray(ref[5]).tolist() == got[5].tolist()
    assert np.asarray(ref[6]).tolist() == got[6].tolist()
    assert got[5].tolist()[0] and got[6].tolist()[0]
    canon = F.limbs_to_ints_batch(got[2].numpy().T)[:12]
    ints = F.limbs_to_ints_batch(a)
    assert canon == [x * y % P for x, y in zip(ints, F.limbs_to_ints_batch(b))][:12]


def test_fp2_ops_digit_exact_with_reference():
    a, b = _rows(2), _rows(3)
    n = a.shape[0] // 2
    ja, jb = (jnp.asarray(a[:n]), jnp.asarray(a[n:])), (jnp.asarray(b[:n]), jnp.asarray(b[n:]))
    with jax.disable_jit():  # compositions of the jitted Fp ops; eager costs less
        ref = (JF.fp2_add(ja, jb), JF.fp2_sub(ja, jb), JF.fp2_mul(ja, jb), JF.fp2_sqr(ja),
               JF.fp2_neg(ja), JF.fp2_is_zero(ja), JF.fp2_eq(ja, jb))
    ta, tb = _cols(a), _cols(b)  # [re | im]: rows 0..n-1 real, n.. imaginary
    got = (F.fp2_add(ta, tb), F.fp2_sub(ta, tb), F.fp2_mul(ta, tb), F.fp2_sqr(ta),
           F.fp2_neg(ta))
    for name, r, g in zip(("add", "sub", "mul", "sqr", "neg"), ref, got):
        re, im = F.fp2_parts(g)
        assert np.array_equal(np.asarray(r[0]), re.numpy().T), name
        assert np.array_equal(np.asarray(r[1]), im.numpy().T), name
    assert np.asarray(ref[5]).tolist() == F.fp2_is_zero(ta).tolist()
    assert np.asarray(ref[6]).tolist() == F.fp2_eq(ta, tb).tolist()
    assert F.fp2_eq(ta, ta).all()
