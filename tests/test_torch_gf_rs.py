"""The port's GF(2^8) device half and Reed–Solomon coder against the JAX
package, exactly, on the CPU (inputs made by numpy from a seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.ops import gf256 as jgf
from hbbft_tpu.ops import rs as jrs
from hbbft_tpu_torch.ops import gf256 as tgf
from hbbft_tpu_torch.ops import rs as trs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_bits_roundtrip_matches_jax():
    x = np.random.default_rng(1).integers(0, 256, (3, 5, 7), dtype=np.uint8)
    bits = tgf.bytes_to_bits(_t(x))
    assert np.array_equal(bits.numpy(), np.asarray(jgf.bytes_to_bits(jnp.asarray(x))))
    assert np.array_equal(tgf.bits_to_bytes(bits).numpy(), x)


def test_gf_mul_and_inv_match_jax_on_all_pairs():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    got = tgf.gf_mul_torch(_t(a), _t(b)).numpy()
    assert np.array_equal(got, np.asarray(jgf.gf_mul_jnp(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(got, jgf.gf_mul(a, b))
    x = np.arange(256, dtype=np.uint8)
    assert np.array_equal(
        tgf.gf_inv_torch(_t(x)).numpy(), np.asarray(jgf.gf_inv_jnp(jnp.asarray(x)))
    )


def test_host_tables_match_jax():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    assert np.array_equal(tgf.vandermonde(9, 5), jgf.vandermonde(9, 5))


@pytest.mark.parametrize("k", [2, 6, 22])
def test_inverse_and_bit_matrices_match_jax(k):
    """Batched Gauss–Jordan with first-nonzero pivoting, including singular
    and pivot-swapping inputs, then the bit-matrix expansion."""
    rng = np.random.default_rng(k)
    M = rng.integers(0, 256, (6, k, k), dtype=np.uint8)
    M[1, :, 0] = 0  # singular
    M[2, 0, 0] = 0  # forces a row swap
    M[3] = jgf.vandermonde(2 * k, k)[k:]
    inv_t, ok_t = tgf.gf_inv_matrix_torch(_t(M))

    def jax_inv_bits(m):  # one compile per k
        inv, ok = jgf.gf_inv_matrix_jnp(m)
        return inv, ok, jgf.gf_matrix_to_bits_jnp(inv)

    inv_j, ok_j, bits_j = jax.jit(jax_inv_bits)(jnp.asarray(M))
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert not ok_t[1] and ok_t[3]
    assert np.array_equal(inv_t.numpy(), np.asarray(inv_j))
    bits_t = tgf.gf_matrix_to_bits_torch(inv_t).numpy()
    assert np.array_equal(bits_t, np.asarray(bits_j))
    assert np.array_equal(bits_t[3], jgf.gf_matrix_to_bits(np.asarray(inv_j)[3]))


def test_apply_bitmatrix_matches_jax_batched():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (2, 3, 40, 5), dtype=np.uint8)
    mats = rng.integers(0, 256, (2, 3, 4, 5), dtype=np.uint8)
    bits = np.stack([[jgf.gf_matrix_to_bits(m) for m in row] for row in mats])
    got = tgf.gf_apply_bitmatrix(_t(data), _t(bits)).numpy()
    ref = np.asarray(jgf.gf_apply_bitmatrix(jnp.asarray(data), jnp.asarray(bits)))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n", [4, 16, 64])
def test_rs_encode_matches_jax_and_host(n):
    f = (n - 1) // 3
    tc, jc = trs.for_n_f(n, f), jrs.for_n_f(n, f)
    assert np.array_equal(tc.matrix, jc.matrix)
    data = np.random.default_rng(n).integers(0, 256, (3, tc.data_shards, 33), dtype=np.uint8)
    got = tc.encode(_t(data)).numpy()
    assert np.array_equal(got, np.asarray(jc.encode_jax(jnp.asarray(data))))
    for p in range(3):
        assert np.array_equal(got[p], jc.encode_np(data[p]))


@pytest.mark.parametrize("n", [4, 16, 64])
def test_rs_reconstruct_matches_jax(n):
    f = (n - 1) // 3
    tc, jc = trs.for_n_f(n, f), jrs.for_n_f(n, f)
    k = tc.data_shards
    data = np.random.default_rng(100 + n).integers(0, 256, (2, k, 21), dtype=np.uint8)
    shards = jc.encode_np(data[0]), jc.encode_np(data[1])
    use = tuple(sorted(np.random.default_rng(n).permutation(n)[:k].tolist()))
    surv = np.stack([s[list(use)] for s in shards])
    got = tc.reconstruct(_t(surv), use).numpy()
    assert np.array_equal(got, np.asarray(jc.reconstruct_jax(jnp.asarray(surv), use)))
    assert np.array_equal(got, data)
