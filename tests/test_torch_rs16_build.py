"""The port's GF(2^16) encode matrix, built in closed form, against the JAX
package's Gauss–Jordan construction, and its bit matrices against the host
layout, on the CPU (inputs made by numpy from a seed)."""

import numpy as np
import pytest
import torch

from hbbft_tpu.ops import gf16 as jgf
from hbbft_tpu_torch.ops import gf16 as tgf
from hbbft_tpu_torch.ops import rs as trs


@pytest.mark.parametrize("data,parity", [(88, 172), (102, 198), (174, 346)])
def test_closed_form_matrix_equals_gauss_jordan(data, parity):
    """The reference's construction, computed here from its parts rather
    than through ``hbbft_tpu.ops.rs.ReedSolomon16``, whose disk cache could
    answer instead."""
    V = jgf.vandermonde(data + parity, data)
    want = jgf.gf_matmul_np(V, jgf.gf_inv_matrix_np(V[:data]))
    got = tgf.systematic_matrix(data + parity, data)
    assert got.dtype == np.uint16 and np.array_equal(got, want)
    assert np.array_equal(trs.ReedSolomon16(data, parity).matrix, want)


def test_closed_form_matrix_interpolates_at_config5_shape():
    """N = 4096, f = 1365: (4096, 1366).  Seeded random polynomials of
    degree 1 365, evaluated at every point x_r = r by Horner's rule: the
    matrix applied to their values at the first 1 366 points gives their
    values at all 4 096."""
    total, data = 4096, 1366
    M = tgf.systematic_matrix(total, data)
    assert np.array_equal(M[:data], np.eye(data, dtype=np.uint16))
    coeffs = np.random.default_rng(41).integers(0, 1 << 16, (data, 3), dtype=np.uint16)
    x = np.arange(total, dtype=np.uint16)[:, None]
    values = np.zeros((total, 3), dtype=np.uint16)
    for c in coeffs[::-1]:
        values = jgf.gf_mul(values, x) ^ c[None, :]
    assert np.array_equal(jgf.gf_matmul_np(M, values[:data]), values)


def test_closed_form_matrix_edges():
    """One data shard (every row is 1), no parity, and bad shapes."""
    assert np.array_equal(tgf.systematic_matrix(5, 1), np.ones((5, 1), dtype=np.uint16))
    assert np.array_equal(tgf.systematic_matrix(4, 4), np.eye(4, dtype=np.uint16))
    for total, data in ((3, 4), (4, 0), ((1 << 16) + 1, 2)):
        with pytest.raises(ValueError):
            tgf.systematic_matrix(total, data)


def test_device_bit_builders_match_host_layout():
    """``gf_matrix_to_bits_torch`` and the column-chunked float32 builder a
    CUDA coder uses, against ``gf_matrix_to_bits`` on a (172, 88) parity
    matrix (88 columns: one whole chunk of 64 and a partial one)."""
    P = tgf.systematic_matrix(260, 88)[88:]
    want = tgf.gf_matrix_to_bits(P)
    assert np.array_equal(want, jgf.gf_matrix_to_bits(P))
    Pt = torch.from_numpy(P.astype(np.int32))
    got = tgf.gf_matrix_to_bits_torch(Pt)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    f32 = tgf.parity_bits_f32(Pt)
    assert f32.dtype == torch.float32 and torch.equal(f32, torch.from_numpy(want).float())


def test_coder_writes_no_cache_and_builds_bits_at_first_use(tmp_path, monkeypatch):
    """No file under HOME; the host bit matrix exists only once an encode
    on the CPU needs it, and the encode is the host encoder's."""
    monkeypatch.setenv("HOME", str(tmp_path))
    coder = trs.ReedSolomon16(102, 198)
    assert list(tmp_path.iterdir()) == []
    assert "_parity_bits" not in coder.__dict__
    data = np.random.default_rng(42).integers(0, 256, (2, 102, 4), dtype=np.uint8)
    got = coder.encode(torch.from_numpy(data)).numpy()
    assert "_parity_bits" in coder.__dict__
    for p in range(2):
        assert np.array_equal(got[p], coder.encode_np(data[p]))
    assert list(tmp_path.iterdir()) == []
