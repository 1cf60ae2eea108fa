"""The 4-bit windowed lazy ladder against the reference, on the CPU.

``gcurve.scalar_mul_lazy_window_plain`` (the windowed kernel's plain
version) is held value-exact at 132 bits against the JAX package's host
curve, and digit- and inf-exact against the reference's own
``scalar_mul_lazy_window``.  The kernel itself (``csrc/ladder_window.cu``)
runs only on the card; here a lane model of it — the same tables as
``csrc/ladder_schedule.h``, walked with their versioned ready flags by
``test_torch_ladder``'s lane model of the step machinery at K elements a
warp — builds the 15-entry table (dbl and addp steps, each entry's
prologue), then runs three dbl steps and one step of the bitwise table a
window, each reading one accumulator set and writing the other, the
step's base block each row's own entry, against the plain version."""

import random

import numpy as np
import pytest
import torch

import test_torch_ladder as lanes_mod
from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu.ops import gcurve as jg
from hbbft_tpu_torch.ops import fp381 as F
from hbbft_tpu_torch.ops import gcurve as G
from hbbft_tpu_torch.ops import ladder_lazy
from hbbft_tpu_torch.ops import ladder_schedule as S


def _points(group, rng, n):
    if group == "g1":
        return [jc.g1_mul(jc.G1_GEN, rng.randrange(1, jc.R)) for _ in range(n)]
    return [jc.g2_mul(jc.G2_GEN, rng.randrange(1, jc.R)) for _ in range(n)]


def _device(group, pts):
    if group == "g1":
        return G.g1_to_device(pts, "cpu"), G.LAZY_FP_OPS
    return G.g2_to_device(pts, "cpu"), G.LAZY_FP2_OPS


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_plain_matches_host_at_132_bits(group):
    """128-bit randomizers, a zero scalar, all-ones bits and a None base."""
    rng = random.Random(71 if group == "g1" else 72)
    pts = _points(group, rng, 3) + [None]
    sc = [rng.getrandbits(128) | 1, 0, (1 << 132) - 1, rng.getrandbits(128)]
    pt, ops = _device(group, pts)
    bits = torch.from_numpy(F.bits_batch(sc, 132))
    base_inf = torch.tensor([p is None for p in pts])
    out, inf = G.scalar_mul_lazy_window_plain(ops, pt, bits, base_inf)
    assert inf.tolist() == [False, True, False, True]
    host = (G.g1_from_device_batch if group == "g1" else G.g2_from_device_batch)(out)
    mul, eq = (jc.g1_mul, jc.g1_eq) if group == "g1" else (jc.g2_mul, jc.g2_eq)
    for h, p, s in zip(host[:3:2], pts[:3:2], sc[:3:2]):
        assert eq(h, mul(p, s))


@pytest.mark.slow  # ~22 s: the reference's eager ops, one dispatch each
def test_window_plain_digit_exact_with_reference():
    """The reference's ``scalar_mul_lazy_window`` under ``jax.disable_jit()``
    (its jitted graph compiles for minutes on the CPU), one window of 4
    bits at 3 G1 rows, a None base among them: digits and inf flags equal,
    garbage digits of the ∞ row included."""
    import jax
    import jax.numpy as jnp

    rng = random.Random(75)
    pts = _points("g1", rng, 2) + [None]
    bits = F.bits_batch([9, 0, 15], 4)
    base_inf = np.array([p is None for p in pts])
    with jax.disable_jit():
        ref, ref_inf = jg.scalar_mul_lazy_window(
            jg.LAZY_FP_OPS, tuple(jnp.asarray(c) for c in jg.g1_to_device(pts)),
            jnp.asarray(bits), jnp.asarray(base_inf))
    got, got_inf = G.scalar_mul_lazy_window_plain(
        G.LAZY_FP_OPS, G.g1_to_device(pts, "cpu"), torch.from_numpy(bits),
        torch.from_numpy(base_inf))
    assert np.asarray(ref_inf).tolist() == got_inf.tolist() == [False, True, True]
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy().T)


def lane_window(group, pt, bits, base_inf, K, lanes=None, row=32, nl=F.NL):
    """``ladder_window.cu`` from its tables on the lane model at K elements
    a warp (``lanes``; the 8-bit field's model runs ``ladder_mxu.cu``, on
    rows of ``row`` words, ``nl`` digits): P's prologue; the table of
    coordinates (entry k − 1 from entry src, copied into A, by an addp or
    dbl step A→B with entry 0 and P's prologue the base, the result copied
    out); then per window dbl A→B with the prologue of the window's entry
    beside it, dbl B→A, dbl A→B and the bitwise table's step B→A whose base
    is each row's own entry."""
    tab = {(k, s): S.build(group, k, s) for k, s in
           (("step", "BA"), ("dbl", "BA"), ("dbl", "AB"), ("addp", "AB"), ("dblpro", "AB"))}
    step = tab["step", "BA"]
    lanes = lanes_mod.LANES[K] if lanes is None else lanes
    n = step.n_acc
    rows = [None] * step.n_slots  # A, B, the temporaries
    pro = [None] * (step.entry_rows - n)  # the base block's prologue values
    table = [lanes_mod.comps(n, pt, row)]  # entry e: (e + 1)·P, coordinates
    lanes_mod.lane_prologue(lanes, step, lanes_mod.Frame(rows, table[0], pro, n))

    def run(sched, base, bit=None, inf=None, binf=None):  # only a select reads the flags
        fr = lanes_mod.Frame(rows, base, pro, n)
        lanes_mod.walk(sched, lambda op: lanes_mod.run_op(lanes, fr, op, bit, inf, binf))

    for k in range(2, 16):
        rows[:n] = table[k - 2 if k % 2 else k // 2 - 1]
        run(tab["addp" if k % 2 else "dbl", "AB"], table[0])
        table.append(rows[n:2 * n])

    rows[:n] = [torch.zeros_like(x) for x in table[0]]
    inf = torch.ones(base_inf.shape, dtype=torch.bool)
    cols = torch.arange(base_inf.shape[0])
    for idx in G.window_indices(bits):
        entry = (idx - 1).clamp(min=0)
        base = [torch.stack([t[c] for t in table])[entry, :, cols].t()
                for c in range(n)]  # each row's own entry, read in place
        run(tab["dblpro", "AB"], base)
        run(tab["dbl", "BA"], None)
        run(tab["dbl", "AB"], None)
        fr = lanes_mod.Frame(rows, base, pro, n)
        inf = lanes_mod.lane_step(lanes, step, fr, inf, base_inf, idx != 0)
    return lanes_mod.point_of(n, rows[:n], nl), inf


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_window_kernel_matches_plain(group, K):
    """8 bits (two windows, zero windows included) at 4 rows, a None base
    among them, K elements a warp: digit- and inf-exact, garbage digits of
    the ∞ row too."""
    rng = random.Random(73 if group == "g1" else 74)
    pts = _points(group, rng, 3) + [None]
    pt, ops = _device(group, pts)
    bits = torch.from_numpy(F.bits_batch([0x5A, 0x07, 0xF0, 0x31], 8))
    base_inf = torch.tensor([p is None for p in pts])
    ref, ref_inf = G.scalar_mul_lazy_window_plain(ops, pt, bits, base_inf)
    got, got_inf = lane_window(group, pt, bits, base_inf, K)
    assert torch.equal(got_inf, ref_inf)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_window_wrapper_takes_only_cuda_tensors():
    pts = G.g1_to_device([None], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ladder_lazy.ladder_window(pts, torch.zeros((1, 4), dtype=torch.int32),
                                  torch.ones(1, dtype=torch.bool), fp2=False)
    with pytest.raises(ValueError, match="multiple of 4"):
        ladder_lazy.ladder_window(pts, torch.zeros((1, 6), dtype=torch.int32),
                                  torch.ones(1, dtype=torch.bool), fp2=False)
