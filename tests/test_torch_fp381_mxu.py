"""The port's 8-bit-digit field and its route against the reference, on the CPU.

``hbbft_tpu_torch/ops/fp381_mxu.py`` is held digit-exact with
``hbbft_tpu/ops/fp381_mxu.py`` (its tables, converters and every Fp and Fp2
operation on adversarial lazy inputs, the reference's ops under
``jax.jit``); the windowed ladder's plain version over ``MXU_FP_OPS`` /
``MXU_FP2_OPS`` digit- and inf-exact with the reference's
``scalar_mul_lazy_window`` over the same tables (its windows run as a
Python loop of jitted field ops: the windowed graph costs minutes to
compile on a CPU); ``crypto/batch.py``'s ``HBBFT_FIELD_BACKEND`` route
against the 13-bit route and the host.  Inputs come from seeded numpy and
``random``."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import batch as jb
from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu.ops import fp381_mxu as JM
from hbbft_tpu.ops import gcurve as jg
from hbbft_tpu_torch.crypto import batch as B
from hbbft_tpu_torch.crypto import bls12_381 as c
from hbbft_tpu_torch.ops import fp381_mxu as M
from hbbft_tpu_torch.ops import gcurve as G

NL = M.NL


def test_tables_and_converters_equal_the_reference():
    for name in ("DIGIT_BITS", "NL", "MASK", "_CARRY_PAD", "_N_HI"):
        assert getattr(M, name) == getattr(JM, name), name
    assert M._CONV_OUT == JM._CONV_OUT == 97  # the reference's comment says 95
    for name in ("P_LIMBS", "_FOLD_ROWS", "_SQUEEZE_ROWS", "_SUBC_LIMBS", "_DIGIT_WEIGHTS"):
        got, want = getattr(M, name), getattr(JM, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    rng = random.Random(3)
    xs = [0, 1, c.P - 1, (1 << 392) - 1] + [rng.getrandbits(392) for _ in range(8)]
    rows = M.ints_to_limbs_batch(xs)
    assert np.array_equal(rows, JM.ints_to_limbs_batch(xs))
    assert all(np.array_equal(M.int_to_limbs(x), JM.int_to_limbs(x)) for x in xs)
    lazy = np.random.default_rng(4).integers(0, 257, size=(6, NL)).astype(np.int32)
    assert M.limbs_to_ints_batch(lazy) == JM.limbs_to_ints_batch(lazy)
    assert [M.limbs_to_int(r) for r in lazy] == [JM.limbs_to_int(r) for r in lazy]
    assert M.limbs_to_ints_batch(rows) == xs


def _lazy_rows(rng, n):
    """(n, NL) digits over the whole lazy invariant [0, 256]: rows of all
    0, all 255, all 256, p − 1, 1, then uniform digits."""
    rows = rng.integers(0, 257, size=(n, NL)).astype(np.int32)
    rows[:5] = np.stack([np.zeros(NL, np.int32), np.full(NL, 255, np.int32),
                         np.full(NL, 256, np.int32), JM.int_to_limbs(c.P - 1),
                         JM.int_to_limbs(1)])
    return rows


def _squeeze_rows(rng):
    """The reference's ``test_squeeze_handles_large_top_digit`` input (every
    limb < 2^31, beyond the lazy invariant: the squeeze's own contract)."""
    cases = np.zeros((4, NL), dtype=np.int64)
    cases[0, NL - 1] = 1 << 24
    cases[1, NL - 1] = (1 << 31) - 1
    cases[2] = rng.integers(0, 1 << 31, size=NL)
    cases[3, 0] = (1 << 31) - 1
    return cases.astype(np.int32)


def _cols(rows):
    return torch.from_numpy(np.ascontiguousarray(rows.T))


# op → (the reference's function, the port's, its kind): "fp" takes and gives
# (B, NL) rows / (NL, B) columns, "fp2" (re, im) rows / (NL, 2B) [re | im]
# columns, "zero" gives bool (B,), "select" takes a mask first
OPS = {
    "fp_mul": (JM.fp_mul, M.fp_mul, "fp", 2),
    "fp_sqr": (JM.fp_sqr, M.fp_sqr, "fp", 1),
    "fp_add": (JM.fp_add, M.fp_add, "fp", 2),
    "fp_sub": (JM.fp_sub, M.fp_sub, "fp", 2),
    "fp_neg": (JM.fp_neg, M.fp_neg, "fp", 1),
    "fp_is_zero_digits": (JM.fp_is_zero_digits, M.fp_is_zero_digits, "fp", 1),
    "fp_select": (JM.fp_select, M.fp_select, "fp", 2),
    "_squeeze": (JM._squeeze, M._squeeze, "squeeze", 1),
    "fp2_mul": (JM.fp2_mul, M.fp2_mul, "fp2", 2),
    "fp2_sqr": (JM.fp2_sqr, M.fp2_sqr, "fp2", 1),
    "fp2_add": (JM.fp2_add, M.fp2_add, "fp2", 2),
    "fp2_sub": (JM.fp2_sub, M.fp2_sub, "fp2", 2),
    "fp2_neg": (JM.fp2_neg, M.fp2_neg, "fp2", 1),
    "fp2_is_zero_digits": (JM.fp2_is_zero_digits, M.fp2_is_zero_digits, "fp2", 1),
    "fp2_select": (JM.fp2_select, M.fp2_select, "fp2", 2),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_digit_exact_with_reference(name):
    """Every operation, digit for digit, on the lazy edges (all digits 0,
    255 or 256, p − 1, 1) and uniform digits in [0, 256], each row against
    every kind of row; the squeeze also on the reference's large-top-digit
    input."""
    ref, port, kind, arity = OPS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 24
    if kind == "squeeze":
        rows = [np.concatenate([_squeeze_rows(rng), _lazy_rows(rng, 8)])]
    elif kind == "fp":
        rows = [_lazy_rows(rng, n)] + [_lazy_rows(rng, n)[::-1].copy() for _ in range(arity - 1)]
    else:  # (re, im) pairs: the first operand's row 0 is 0, the second's reversed
        rows = [(_lazy_rows(rng, n), _lazy_rows(rng, n))]
        rows += [(_lazy_rows(rng, n)[::-1].copy(), _lazy_rows(rng, n)) for _ in range(arity - 1)]
    mask = rng.integers(0, 2, size=n).astype(bool)
    if kind == "fp2":
        jargs = [tuple(map(jnp.asarray, r)) for r in rows]
        args = [torch.cat([_cols(re), _cols(im)], dim=1) for re, im in rows]
    else:
        jargs = [jnp.asarray(r) for r in rows]
        args = [_cols(r) for r in rows]
    if name.endswith("select"):
        jargs, args = [jnp.asarray(mask)] + jargs, [torch.from_numpy(mask)] + args
    want, got = jax.jit(ref)(*jargs), port(*args)
    if name.endswith("is_zero_digits"):
        assert got.tolist() == np.asarray(want).tolist()
        assert got.any()  # the all-zero element
        return
    if kind == "fp2":
        want = np.concatenate([np.asarray(want[0]), np.asarray(want[1])])
    want = np.asarray(want).T
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if not name.endswith("select"):
        assert 0 <= got.min() and got.max() <= 256  # the lazy invariant


def _fori(lo, hi, body, init):
    v = init
    for i in range(lo, hi):
        v = body(i, v)
    return v


class _JitOps:
    """A reference ops table with each field op jitted on its own."""

    def __init__(self, base):
        for op in ("add", "sub", "mul", "sqr", "neg", "is_zero", "select"):
            setattr(self, op, jax.jit(getattr(base, op)))


def _points(group, rng, n):
    if group == "g1":
        return [jc.g1_mul(jc.G1_GEN, rng.randrange(1, jc.R)) for _ in range(n)]
    return [jc.g2_mul(jc.G2_GEN, rng.randrange(1, jc.R)) for _ in range(n)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_ladder_digit_exact_with_reference(group, monkeypatch):
    """``scalar_mul_lazy_window_plain`` over the 8-bit field against the
    reference's ``scalar_mul_lazy_window(G.MXU_FP_OPS, …)`` at 8 bits and 4
    rows, one base at infinity and one zero scalar: every digit (the ∞
    rows' garbage digits too) and every inf flag.  The reference's
    ``fori_loop`` runs as the Python loop it stands for."""
    monkeypatch.setattr(jax.lax, "fori_loop", _fori)
    rng = random.Random(81 if group == "g1" else 82)
    pts = _points(group, rng, 3)
    pts.insert(2, None)
    scalars = [rng.getrandbits(8) | 1, 0, rng.getrandbits(8), 0xA5]
    bits = jg.scalars_to_bits(scalars, nbits=8)
    base_inf = np.array([p is None for p in pts])
    if group == "g1":
        ref_ops, ops = _JitOps(jg.MXU_FP_OPS), G.MXU_FP_OPS
        jpt = tuple(jnp.asarray(x) for x in jg.g1_to_device(pts, rep=JM))
        pt = G.g1_to_device(pts, "cpu", rep=M)
    else:
        ref_ops, ops = _JitOps(jg.MXU_FP2_OPS), G.MXU_FP2_OPS
        jpt = tuple(tuple(jnp.asarray(x) for x in co) for co in jg.g2_to_device(pts, rep=JM))
        pt = G.g2_to_device(pts, "cpu", rep=M)
    ref, ref_inf = jg.scalar_mul_lazy_window(ref_ops, jpt, jnp.asarray(bits),
                                             jnp.asarray(base_inf))
    got, got_inf = G.scalar_mul_lazy_window_plain(ops, pt, torch.from_numpy(bits),
                                                  torch.from_numpy(base_inf))
    assert got_inf.tolist() == np.asarray(ref_inf).tolist() == [False, True, True, False]
    for r, g in zip(ref, got):
        if group == "g2":
            r = np.concatenate([np.asarray(r[0]), np.asarray(r[1])])
        assert np.array_equal(g.numpy(), np.asarray(r).T)


def test_window_ladder_matches_host_at_64_bits():
    """G1 over the 8-bit field at 64 bits against the port's host curve."""
    rng = random.Random(83)
    pts = [c.g1_mul(c.G1_GEN, rng.randrange(1, c.R)) for _ in range(3)] + [None]
    scalars = [rng.getrandbits(64) for _ in range(3)] + [12345]
    bits = torch.from_numpy(G.scalars_to_bits(scalars, nbits=64))
    base_inf = torch.tensor([p is None for p in pts])
    out, inf = G.scalar_mul_lazy_window_plain(G.MXU_FP_OPS, G.g1_to_device(pts, "cpu", rep=M),
                                              bits, base_inf)
    assert inf.tolist() == [False, False, False, True]
    host = G.g1_from_device_batch(out, rep=M)
    for h, p, s in zip(host[:3], pts[:3], scalars[:3]):
        assert c.g1_eq(h, c.g1_mul(p, s))


def test_msm_cache_under_the_mxu_backend(monkeypatch):
    """``HBBFT_FIELD_BACKEND=mxu``: ``msm_g1``, ``msm_g2`` and
    ``g1_mul_batch`` run the 8-bit field and equal the 13-bit route and
    the host."""
    rng = random.Random(84)
    g1 = [c.g1_mul(c.G1_GEN, rng.randrange(1, c.R)) for _ in range(3)]
    g2 = [c.g2_mul(c.G2_GEN, rng.randrange(1, c.R)) for _ in range(2)]
    rs1 = [rng.getrandbits(128) | 1 for _ in g1]
    rs2 = [rng.getrandbits(128) | 1 for _ in g2]
    full = [rng.randrange(c.R) for _ in g1]
    cache = B.cache_for("cpu", mesh=None)
    fields = []
    real_window = G.scalar_mul_lazy_window

    def spy(o, *args):
        fields.append(o.field)
        return real_window(o, *args)

    monkeypatch.setattr(G, "scalar_mul_lazy_window", spy)
    results = {}
    for backend in ("mxu", "lazy"):
        monkeypatch.setenv("HBBFT_FIELD_BACKEND", backend)
        results[backend] = (cache.msm_g1(g1, rs1), cache.msm_g2(g2, rs2),
                            cache.g1_mul_batch(g1, full))
    assert fields == ["mxu"] * 3 + ["lazy"] * 3
    want_g1, want_g2 = None, None
    for p, r in zip(g1, rs1):
        want_g1 = c.g1_add(want_g1, c.g1_mul(p, r))
    for p, r in zip(g2, rs2):
        want_g2 = c.g2_add(want_g2, c.g2_mul(p, r))
    for m1, m2, muls in results.values():
        assert c.g1_eq(m1, want_g1) and c.g2_eq(m2, want_g2)
        assert all(c.g1_eq(got, c.g1_mul(p, s)) for got, p, s in zip(muls, g1, full))


def test_field_backend_knob(monkeypatch):
    """The reference's rules: unset, empty, ``lazy`` or ``mxu``; any other
    value raises the reference's ``ValueError``.  Unforced, the port's
    default (``MXU_MAX_BATCH`` None) is the 13-bit field at every size."""
    from hbbft_tpu_torch.ops import fp381 as F

    assert B.MXU_MAX_BATCH is None
    monkeypatch.delenv("HBBFT_FIELD_BACKEND", raising=False)
    assert B._field_rep(2)[0] is F and B._field_rep(1 << 20)[0] is F
    monkeypatch.setenv("HBBFT_FIELD_BACKEND", "")
    assert B._field_rep(4) == (F, G.LAZY_FP_OPS, G.LAZY_FP2_OPS)
    for value, rep, ops in (("lazy", F, G.LAZY_FP_OPS), ("mxu", M, G.MXU_FP_OPS)):
        monkeypatch.setenv("HBBFT_FIELD_BACKEND", value)
        assert B._field_rep(1 << 20)[:2] == (rep, ops)
        assert jb._field_rep(1 << 20)[0].__name__ == rep.__name__.replace("hbbft_tpu_torch",
                                                                          "hbbft_tpu")
    monkeypatch.setenv("HBBFT_FIELD_BACKEND", "bogus")
    with pytest.raises(ValueError) as want:
        jb._field_rep(4)
    with pytest.raises(ValueError) as got:
        B._field_rep(4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="expected 'mxu' or 'lazy'"):
        B.cache_for("cpu", mesh=None).msm_g1([c.G1_GEN], [3])


def test_row_sharded_msm_under_the_mxu_backend(monkeypatch):
    """A 2-rank gloo world under ``HBBFT_FIELD_BACKEND=mxu`` (its ranks
    inherit the variable): the ladder of 4 rows runs row-sharded, its rows
    gathered in the 8-bit field's layout, one row unsharded; both equal the
    host's sums."""
    from hbbft_tpu_torch import graft_entry

    monkeypatch.setenv("HBBFT_FIELD_BACKEND", "mxu")
    world = graft_entry.start_world(
        2, graft_entry.check_rank, ([("msm", "msm", {"rows": (4, 1)})],), device="cpu")
    try:
        per_rank = world.results(timeout_s=300)
    finally:
        world.close()
    for res in per_rank:
        got = res["msm"]["out"]
        assert got[4]["sharded"] and not got[1]["sharded"]
        assert all(v["msm"] == v["host"] for v in got.values())
