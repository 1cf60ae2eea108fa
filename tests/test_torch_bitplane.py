"""The port's packed bit planes and its GF(2) product over packed bits
(``ops/gf256.py`` ``bitplane_packed``, the plain version the CPU runs),
against the JAX package's int8 bit matrices and ``gf_apply_bitmatrix``,
exactly, on the CPU (inputs made by numpy from a seed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.ops import gf16 as jgf16
from hbbft_tpu.ops import gf256 as jgf8
from hbbft_tpu.ops import rs as jrs
from hbbft_tpu_torch.ops import gf16 as tgf16
from hbbft_tpu_torch.ops import gf256 as tgf8
from hbbft_tpu_torch.ops import rs as trs

# (n, f) → (k, r): N = 64 over GF(2^8) (k = 22), N = 259 over GF(2^16)
# (k = 87): contraction lengths of 176 and 1 392 bits, neither a multiple of
# a 32-bit word's worth of symbols in the second field (87 is odd)
GF8_NF = (64, 21)
GF16_NF = (259, 86)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gf16_parity(n, f):
    k = n - 2 * f
    return tgf16.systematic_matrix(n, k)[k:]


@pytest.mark.parametrize("d", [1, 8, 31, 32, 33, 176, 513, 1392])
def test_pack_round_trips(d):
    rng = np.random.default_rng(d)
    bits = rng.integers(0, 2, (3, 5, d), dtype=np.int8)
    packed = tgf8.pack_bits(_t(bits))
    words = tgf8.packed_words(d)
    assert packed.dtype == torch.int32 and packed.shape == (3, 5, words)
    assert words % tgf8.PACK_WORDS == 0 and 32 * words >= d
    assert np.array_equal(tgf8.unpack_bits(packed, d).numpy(), bits)
    # bit p is bit p % 32 of word p // 32, and the padding is zero
    u = packed.numpy().view(np.uint32)
    for p in sorted({0, d // 2, d - 1}):
        assert np.array_equal((u[..., p // 32] >> (p % 32)) & 1, bits[..., p])
    tail = np.unpackbits(u.view(np.uint8), axis=-1, bitorder="little")[..., d:]
    assert not tail.any()
    mat = rng.integers(0, 2, (2, d, 24), dtype=np.int8)
    pm = tgf8.pack_matrix(_t(mat))
    assert pm.shape == (2, 24, words)
    assert np.array_equal(tgf8.unpack_matrix(pm, d).numpy(), mat)


def test_data_packing_is_the_reference_bit_layout():
    """A packed row is the reference's data bits: GF(2^8) rows are their
    bytes, GF(2^16) rows the symbols of one byte pair across the shards;
    the packed product's output bytes are the reference's repacked bits."""
    rng = np.random.default_rng(3)
    k8 = GF8_NF[0] - 2 * GF8_NF[1]
    x8 = rng.integers(0, 256, (2, 7, k8), dtype=np.uint8)
    w8 = tgf8.packed_words(8 * k8)
    got = tgf8.unpack_bits(tgf8.pack_bytes(_t(x8), w8), 8 * k8).numpy()
    assert np.array_equal(got, np.asarray(jgf8.bytes_to_bits(jnp.asarray(x8))))

    k16 = GF16_NF[0] - 2 * GF16_NF[1]
    x16 = rng.integers(0, 256, (2, k16, 6), dtype=np.uint8)
    w16 = tgf8.packed_words(16 * k16)
    want = np.asarray(jgf16.bytes_to_symbol_bits(jnp.asarray(x16)))
    got = tgf8.unpack_bits(tgf16.pack_shards(_t(x16), w16), 16 * k16).numpy()
    assert np.array_equal(got, want)
    # strided views: a column slice at an odd byte offset, a row slice
    wide = rng.integers(0, 256, (2, k16 + 1, 9), dtype=np.uint8)
    for view in (_t(wide)[:, 1:, 1:7], _t(wide)[:, :k16, 2:8]):
        want = np.asarray(jgf16.bytes_to_symbol_bits(jnp.asarray(view.numpy())))
        got = tgf8.unpack_bits(tgf16.pack_shards(view, w16), 16 * k16).numpy()
        assert np.array_equal(got, want)
    # the output side: r = 5 symbols a row, three rows (B = 6 bytes)
    obits = rng.integers(0, 2, (2, 3, 5 * 16), dtype=np.int8)
    got = tgf16.unpack_shards(tgf8.bits_to_bytes(_t(obits)), 5).numpy()
    assert np.array_equal(got, np.asarray(jgf16.symbol_bits_to_bytes(jnp.asarray(obits), 5)))


def test_packed_matrices_equal_the_reference_bit_matrices():
    """Both fields: the coders' packed parity matrices are ``pack_matrix``
    of the reference's int8 ``gf_matrix_to_bits``, and unpack to it."""
    n, f = GF8_NF
    coder8 = trs.for_n_f(n, f)
    ref8 = jgf8.gf_matrix_to_bits(jrs.ReedSolomon(n - 2 * f, 2 * f).parity_matrix)
    got8 = coder8._on("cpu")
    assert got8.shape == (8 * 2 * f, tgf8.packed_words(8 * (n - 2 * f)))
    assert torch.equal(got8, tgf8.pack_matrix(_t(ref8)))
    assert np.array_equal(tgf8.unpack_matrix(got8, ref8.shape[0]).numpy(), ref8)

    P = _gf16_parity(*GF16_NF)
    ref16 = jgf16.gf_matrix_to_bits(P)
    got16 = tgf16.parity_bits_packed(_t(P.astype(np.int32)))
    assert got16.shape == (16 * P.shape[0], tgf8.packed_words(16 * P.shape[1]))
    assert torch.equal(got16, tgf8.pack_matrix(_t(ref16)))
    assert np.array_equal(tgf8.unpack_matrix(got16, ref16.shape[0]).numpy(), ref16)


def test_packed_coder_build_on_cpu_equals_packed_host_bits():
    """The column-chunked builder a CUDA coder runs, here on the CPU, and
    the coder's own CPU matrix (its host bits, packed): 87 columns are one
    chunk of 64 and a partial one of odd width."""
    n, f = GF16_NF
    coder = trs.ReedSolomon16(n - 2 * f, 2 * f)
    built = tgf16.parity_bits_packed(_t(coder.parity_matrix.astype(np.int32)))
    host = tgf8.pack_matrix(_t(coder._parity_bits))
    assert torch.equal(built, host) and torch.equal(coder._on("cpu"), host)


def test_plain_packed_product_equals_reference_encode():
    """Encode in both fields: the packed product (its plain version on the
    CPU) against the reference's ``gf_apply_bitmatrix``, and the coders'
    ``encode`` against the reference's."""
    rng = np.random.default_rng(5)
    n, f = GF8_NF
    k, r = n - 2 * f, 2 * f
    ref_coder = jrs.ReedSolomon(k, r)
    bits8 = ref_coder._parity_bits
    d8 = rng.integers(0, 256, (3, 7, k), dtype=np.uint8)
    want = np.asarray(jgf8.gf_apply_bitmatrix(jnp.asarray(d8), jnp.asarray(bits8)))
    coder = trs.for_n_f(n, f)
    assert np.array_equal(tgf8.gf_apply_packed(_t(d8), coder._on("cpu")).numpy(), want)
    assert np.array_equal(tgf8.gf_apply_bitmatrix(_t(d8), _t(bits8)).numpy(), want)
    shards = rng.integers(0, 256, (3, k, 9), dtype=np.uint8)
    assert np.array_equal(coder.encode(_t(shards)).numpy(),
                          np.asarray(ref_coder.encode_jax(jnp.asarray(shards))))

    n, f = GF16_NF
    k, r = n - 2 * f, 2 * f
    P = _gf16_parity(n, f)
    bits16 = jgf16.gf_matrix_to_bits(P)
    d16 = rng.integers(0, 256, (2, k, 6), dtype=np.uint8)
    want = np.asarray(jgf16.gf_apply_bitmatrix(jnp.asarray(d16), jnp.asarray(bits16)))
    coder16 = trs.ReedSolomon16(k, r)
    assert np.array_equal(tgf16.gf_apply_packed(_t(d16), coder16._on("cpu")).numpy(), want)
    assert np.array_equal(tgf16.gf_apply_bitmatrix(_t(d16), _t(bits16)).numpy(), want)
    full = coder16.encode(_t(d16)).numpy()
    for p in range(2):
        assert np.array_equal(full[p], coder16.encode_np(d16[p]))


def _survivor_sets(rng, n, k, count):
    return np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(count)])


def test_plain_packed_product_equals_reference_batched_decode():
    """Data-dependent decode matrices, one per (receiver, proposer), as the
    RBC's masked path builds them: the reference's batched
    ``gf_matrix_to_bits_jnp`` and ``gf_apply_bitmatrix`` against the port's
    ``gf_matrix_to_bits_torch`` and packed product, in both fields."""
    rng = np.random.default_rng(6)
    n, f = GF8_NF
    k = n - 2 * f
    enc = trs.for_n_f(n, f).matrix
    uses = _survivor_sets(rng, n, k, 6)
    dec = np.stack([tgf8.gf_inv_matrix_np(enc[u]) for u in uses]).reshape(2, 3, k, k)
    data = rng.integers(0, 256, (2, 3, 5, k), dtype=np.uint8)
    ref_bits = jgf8.gf_matrix_to_bits_jnp(jnp.asarray(dec))
    want = np.asarray(jgf8.gf_apply_bitmatrix(jnp.asarray(data), ref_bits))
    got = tgf8.gf_apply_bitmatrix(_t(data), tgf8.gf_matrix_to_bits_torch(_t(dec)))
    assert np.array_equal(got.numpy(), want)

    n, f = GF16_NF
    k = n - 2 * f
    enc16 = tgf16.systematic_matrix(n, k)
    uses = _survivor_sets(rng, n, k, 2)
    dec16 = np.stack([tgf16.gf_inv_matrix_np(enc16[u]) for u in uses])
    data16 = rng.integers(0, 256, (2, k, 4), dtype=np.uint8)
    want = np.asarray(jgf16.gf_apply_bitmatrix(
        jnp.asarray(data16), jgf16.gf_matrix_to_bits_jnp(jnp.asarray(dec16))))
    got = tgf16.gf_apply_bitmatrix(
        _t(data16), tgf16.gf_matrix_to_bits_torch(_t(dec16.astype(np.int32))))
    assert np.array_equal(got.numpy(), want)
    # decoding the survivors of an encoded block gives its data back
    full = trs.ReedSolomon16(k, 2 * f).encode(_t(data16)).numpy()
    surv = np.stack([full[i, uses[i]] for i in range(2)])
    back = tgf16.gf_apply_bitmatrix(
        _t(surv), tgf16.gf_matrix_to_bits_torch(_t(dec16.astype(np.int32))))
    assert np.array_equal(back.numpy(), data16)


def test_bitplane_packed_broadcasts_and_checks_its_operands():
    rng = np.random.default_rng(7)
    W = 2 * tgf8.PACK_WORDS
    a = _t(rng.integers(-2**31, 2**31, (2, 3, 5, W), dtype=np.int64).astype(np.int32))
    m = _t(rng.integers(-2**31, 2**31, (24, W), dtype=np.int64).astype(np.int32))
    mb = _t(rng.integers(-2**31, 2**31, (3, 24, W), dtype=np.int64).astype(np.int32))
    au = a.numpy().view(np.uint32)

    def want(mat):
        mu = mat.numpy().view(np.uint32)
        pop = np.unpackbits((au[..., None, :] & mu[..., None, :, :]).view(np.uint8),
                            axis=-1).sum(axis=-1) & 1
        return np.packbits(pop.astype(np.uint8), axis=-1, bitorder="little")

    assert np.array_equal(tgf8.bitplane_packed(a, m).numpy(), want(m))
    assert np.array_equal(tgf8.bitplane_packed(a, mb).numpy(), want(mb))
    half = tgf8.PACK_WORDS // 2
    for bad_a, bad_m in ((a.long(), m), (a[..., :half], m[..., :half]), (a, m[:20]),
                         (a, m[:, :tgf8.PACK_WORDS])):
        with pytest.raises((TypeError, ValueError)):
            tgf8.bitplane_packed(bad_a, bad_m)
