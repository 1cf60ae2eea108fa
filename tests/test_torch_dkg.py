"""The port's DKG polynomials and commitment evaluations, on the CPU.

``BivarPoly``/``BivarCommitment`` of the port's ``crypto/tc.py`` against the
JAX package's from the same seed; ``poly_eval_range`` and
``bivar_rows_range`` against the JAX package's; ``bivar_commitment``,
``commitment_row`` and ``commitment_eval`` on the forced device route
(each call's threshold set to 1: the GLV-split windowed ladder's plain
version on CPU tensors) and on the forced host route, equal to
``hbbft_tpu.crypto.batch``'s host-route results, at t = 2–4."""

import random

import pytest

from hbbft_tpu.crypto import batch as jb
from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu.crypto import tc as jtc
from hbbft_tpu_torch.crypto import batch as tb
from hbbft_tpu_torch.crypto import tc


def _polys(t, seed):
    return tc.BivarPoly.random(t, random.Random(seed)), jtc.BivarPoly.random(t, random.Random(seed))


def _row_bytes(com):
    return [jc.g1_to_bytes(p) for p in com.points]


def test_bivar_poly_and_commitment_match_reference():
    poly, jpoly = _polys(3, 51)
    assert poly.coeffs == jpoly.coeffs and poly.degree() == 3
    assert poly.evaluate(5, 9) == jpoly.evaluate(5, 9) == poly.evaluate(9, 5)
    assert poly.row(4).coeffs == jpoly.row(4).coeffs
    com, jcom = poly.commitment(), jpoly.commitment()
    assert com.to_bytes() == jcom.to_bytes()
    assert _row_bytes(com.row(4)) == _row_bytes(jcom.row(4))
    assert _row_bytes(com.row(0)) == _row_bytes(jcom.row(0))
    assert jc.g1_eq(com.evaluate(2, 7), jcom.evaluate(2, 7))
    assert com == tc.BivarCommitment(3, com.points) and hash(com) == hash(jcom)


@pytest.mark.parametrize("t", [2, 4])
def test_poly_and_bivar_ranges_match_reference(t):
    poly, jpoly = _polys(t, 52 + t)
    coeffs = poly.coeffs[1]
    for n in (1, t + 1, 3 * t + 5):
        assert tb.poly_eval_range(coeffs, n) == jb.poly_eval_range(coeffs, n)
    got = tb.bivar_rows_range(poly, 2 * t + 3)
    want = jb.bivar_rows_range(jpoly, 2 * t + 3)
    assert [p.coeffs for p in got] == [p.coeffs for p in want]


@pytest.mark.parametrize("t", [2, 3])
def test_commitment_calls_on_both_routes(t, monkeypatch):
    poly, jpoly = _polys(t, 55 + t)
    jcom = jpoly.commitment()
    want_row = _row_bytes(jb.commitment_row(jcom, 3))
    want_eval = jc.g1_to_bytes(jb.commitment_eval(jcom, 3, 6))
    want_com = jb.bivar_commitment(jpoly).to_bytes()
    assert want_com == jcom.to_bytes()

    thresholds = ("DEVICE_BIVAR_MIN_BATCH", "DEVICE_ROW_MIN_BATCH", "DEVICE_EVAL_MIN_BATCH")
    for name in thresholds:
        monkeypatch.setattr(tb, name, 1 << 30)
    com = tb.bivar_commitment(poly, device="cpu")  # the host route
    assert com.to_bytes() == want_com
    assert _row_bytes(tb.commitment_row(com, 3, device="cpu")) == want_row
    for name in thresholds:
        monkeypatch.setattr(tb, name, 1)
        assert tb._device_worthwhile((t + 1) ** 2, getattr(tb, name))
    assert tb.bivar_commitment(poly, device="cpu").to_bytes() == want_com
    assert _row_bytes(tb.commitment_row(com, 3, device="cpu")) == want_row
    assert jc.g1_to_bytes(tb.commitment_eval(com, 3, 6, device="cpu")) == want_eval
