"""The port's GF(2^16) field and its Reed–Solomon coder against the JAX
package, exactly, on the CPU (inputs made by numpy from a seed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.ops import gf16 as jgf
from hbbft_tpu.ops import rs as jrs
from hbbft_tpu_torch.ops import gf16 as tgf
from hbbft_tpu_torch.ops import gf256 as tgf8
from hbbft_tpu_torch.ops import rs as trs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def coders():
    """ReedSolomon16(88, 172) on both sides: 260 shards, past GF(2^8)."""
    return trs.ReedSolomon16(88, 172), jrs.ReedSolomon16(88, 172)


def test_host_tables_and_matrices_match_jax():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    assert np.array_equal(tgf.vandermonde(33, 9), jgf.vandermonde(33, 9))
    assert [tgf.gf_pow(a, e) for a in (0, 1, 7, 65535) for e in (0, 1, 9)] == [
        jgf.gf_pow(a, e) for a in (0, 1, 7, 65535) for e in (0, 1, 9)
    ]
    rng = np.random.default_rng(5)
    A = rng.integers(0, 1 << 16, (7, 5), dtype=np.uint16)
    B = rng.integers(0, 1 << 16, (5, 6), dtype=np.uint16)
    assert np.array_equal(tgf.gf_matmul_np(A, B), jgf.gf_matmul_np(A, B))
    assert np.array_equal(tgf.gf_matrix_to_bits(A), jgf.gf_matrix_to_bits(A))
    V = jgf.vandermonde(12, 12)[4:12, :8]
    assert np.array_equal(tgf.gf_inv_matrix_np(V), jgf.gf_inv_matrix_np(V))


def test_gf_mul_and_inv_match_jax():
    """10^5 seeded pairs (zeros included), and every nonzero inverse."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 1 << 16, 100_000, dtype=np.uint16)
    b = rng.integers(0, 1 << 16, 100_000, dtype=np.uint16)
    a[:50] = 0
    b[25:75] = 0
    got = tgf.gf_mul_torch(_t(a.astype(np.int32)), _t(b.astype(np.int32))).numpy()
    assert np.array_equal(got, np.asarray(jgf.gf_mul_jnp(jnp.asarray(a), jnp.asarray(b))))
    x = np.arange(1, 1 << 16, dtype=np.uint16)
    inv = tgf.gf_inv_torch(_t(x.astype(np.int32))).numpy()
    assert np.array_equal(inv, np.asarray(jgf.gf_inv_jnp(jnp.asarray(x))))
    assert np.array_equal(inv, jgf.gf_inv(x))
    assert int(tgf.gf_inv_torch(torch.zeros(1, dtype=torch.int32))[0]) == 0


@pytest.mark.parametrize("k", [6, 23])
def test_batched_inverse_and_bits_match_jax(k):
    """Gauss–Jordan with first-nonzero pivoting over a batch holding a
    singular member and a pivot swap, then the bit-matrix expansion."""
    rng = np.random.default_rng(k)
    M = rng.integers(0, 1 << 16, (5, k, k), dtype=np.uint16)
    M[1, :, 2] = 0  # singular
    M[2, 0, 0] = 0  # forces a row swap
    M[3] = jgf.vandermonde(2 * k, k)[k:]
    inv_t, ok_t = tgf.gf_inv_matrix_torch(_t(M.astype(np.int32)))
    inv_j, ok_j = (np.asarray(x) for x in jgf.gf_inv_matrix_jnp(jnp.asarray(M)))
    assert np.array_equal(ok_t.numpy(), ok_j)
    assert not ok_t[1] and ok_t[3]
    assert np.array_equal(inv_t.numpy()[ok_j], inv_j[ok_j])
    assert np.array_equal(inv_t.numpy()[3], jgf.gf_inv_matrix_np(M[3]))
    good = inv_t[ok_t]
    bits_t = tgf.gf_matrix_to_bits_torch(good).numpy()
    bits_j = np.asarray(jgf.gf_matrix_to_bits_jnp(jnp.asarray(inv_j[ok_j])))
    assert np.array_equal(bits_t, bits_j)
    assert np.array_equal(bits_t[0], jgf.gf_matrix_to_bits(inv_j[ok_j][0]))


def test_symbol_bits_roundtrip_and_match_jax():
    """Shards packed as the bit-plane product reads them are the
    reference's symbol bits; its packed output bytes unpack to shards as the
    reference repacks its bits."""
    x = np.random.default_rng(8).integers(0, 256, (3, 5, 10), dtype=np.uint8)
    words = tgf8.packed_words(16 * 5)
    bits = tgf8.unpack_bits(tgf.pack_shards(_t(x), words), 16 * 5)
    assert bits.dtype == torch.int8
    assert np.array_equal(bits.numpy(), np.asarray(jgf.bytes_to_symbol_bits(jnp.asarray(x))))
    assert np.array_equal(tgf.unpack_shards(tgf8.bits_to_bytes(bits), 5).numpy(), x)
    assert np.array_equal(
        tgf.unpack_shards(tgf8.bits_to_bytes(bits), 5).numpy(),
        np.asarray(jgf.symbol_bits_to_bytes(jnp.asarray(bits.numpy()), 5)),
    )


def test_apply_bitmatrix_matches_jax():
    """A constant matrix, and batched data-dependent ones."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (2, 3, 7, 12), dtype=np.uint8)
    M = rng.integers(0, 1 << 16, (4, 7), dtype=np.uint16)
    bits = jgf.gf_matrix_to_bits(M)
    got = tgf.gf_apply_bitmatrix(_t(data), _t(bits)).numpy()
    assert np.array_equal(got, np.asarray(jgf.gf_apply_bitmatrix(jnp.asarray(data), jnp.asarray(bits))))
    mats = rng.integers(0, 1 << 16, (2, 3, 4, 7), dtype=np.uint16)
    bb = np.stack([[jgf.gf_matrix_to_bits(m) for m in row] for row in mats])
    got = tgf.gf_apply_bitmatrix(_t(data), _t(bb)).numpy()
    assert np.array_equal(got, np.asarray(jgf.gf_apply_bitmatrix(jnp.asarray(data), jnp.asarray(bb))))


def test_bitplane_parity_is_the_gf2_product():
    """The shared contraction of both fields: (bits @ bitmat) & 1, as an
    integer product computes it, by the plain version and by the product
    over the packed operands."""
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (3, 9, 200), dtype=np.int8)
    mat = rng.integers(0, 2, (200, 24), dtype=np.int8)
    want = (bits.astype(np.int64) @ mat.astype(np.int64)) & 1
    got = tgf8.bitplane_parity_plain(_t(bits), _t(mat))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    packed = tgf8.bitplane_packed(tgf8.pack_bits(_t(bits)), tgf8.pack_matrix(_t(mat)))
    assert np.array_equal(tgf8.bytes_to_bits(packed).numpy(), want)


def test_rs16_encode_matches_jax_and_host(coders):
    t, j = coders
    assert np.array_equal(t.matrix, j.matrix)
    assert np.array_equal(t._parity_bits, j._parity_bits)
    data = np.random.default_rng(11).integers(0, 256, (3, 88, 6), dtype=np.uint8)
    got = t.encode(_t(data)).numpy()
    assert np.array_equal(got, np.asarray(j.encode_jax(jnp.asarray(data))))
    for p in range(3):
        assert np.array_equal(got[p], j.encode_np(data[p]))
        assert np.array_equal(t.encode_np(data[p]), got[p])


def test_rs16_reconstruct_matches_jax(coders):
    """A seeded erasure set, parity-heavy: the decode matrix and the data
    rows equal the JAX coder's, and the data rows are the originals."""
    t, j = coders
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (88, 8), dtype=np.uint8)
    shards = j.encode_np(data)
    use = tuple(sorted(rng.choice(260, 88, replace=False).tolist()))
    assert np.array_equal(t.decode_matrix(use), j.decode_matrix(use))
    rec = t.reconstruct_data_np(shards[list(use)], use)
    assert np.array_equal(rec, j.reconstruct_data_np(shards[list(use)], use))
    assert np.array_equal(rec, data)


def test_for_n_f_picks_field_by_size():
    assert type(trs.for_n_f(256, 85)) is trs.ReedSolomon
    assert type(trs.for_n_f(300, 99)) is trs.ReedSolomon16
    assert trs.for_n_f(300, 99).data_shards == jrs.for_n_f(300, 99).data_shards == 102
