"""The 4-bit windowed lazy ladder against the reference, on the CPU.

``gcurve.scalar_mul_lazy_window_plain`` (the windowed kernel's plain
version) is held value-exact at 132 bits against the JAX package's host
curve, and digit- and inf-exact against the reference's own
``scalar_mul_lazy_window``.  The kernel itself (``csrc/ladder_window.cu``)
runs only on the card; here a lane model of it — the same tables as
``csrc/ladder_schedule.h``, walked with their ready flags by
``test_torch_ladder``'s lane model of the step machinery — builds the
15-entry table (dbl and addp steps, each entry's prologue), then runs
three dbl steps and one step of the bitwise table a window with the
selected entry copied into the base block, against the plain version."""

import random

import numpy as np
import pytest
import torch

import test_torch_ladder as lanes
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


def lane_window(group, pt, bits, base_inf):
    """``ladder_window.cu`` from its tables on the lane model: the table,
    then per window three dbl steps and one step of the bitwise table."""
    step, dbl, addp = (S.build(group, k) for k in S.KINDS)
    n_acc, first = step.n_acc, step.first_temp
    slots = lanes.slots_of(step, tuple(torch.zeros_like(c) for c in pt), pt)
    slots += [None] * (max(dbl.n_slots, addp.n_slots) - len(slots))
    lanes.lane_prologue(step, slots)

    def run(sched, bit=None, inf=None, binf=None):  # only a select reads the flags
        lanes.walk(sched, lambda op: lanes.run_op(slots, op, bit, inf, binf))

    table = [slots[n_acc:first]]  # entry e: (e + 1)·P, the base block's rows
    for k in range(2, 16):
        slots[:n_acc] = table[k - 2 if k % 2 else k // 2 - 1][:n_acc]
        sched = addp if k % 2 else dbl
        run(sched)
        table.append([slots[o] for o in sched.outs] + [None] * (first - 2 * n_acc))
    for e in range(1, 15):  # each entry's prologue on the entry's own rows
        block = [None] * n_acc + table[e]
        lanes.lane_prologue(step, block)
        table[e] = block[n_acc:]

    slots[:n_acc] = [torch.zeros_like(s) for s in slots[:n_acc]]
    inf = torch.ones(base_inf.shape, dtype=torch.bool)
    cols = torch.arange(base_inf.shape[0])
    for idx in G.window_indices(bits):
        for _ in range(3):
            run(dbl)
            slots[:n_acc] = [slots[o] for o in dbl.outs]
        entry = (idx - 1).clamp(min=0)
        slots[n_acc:first] = [torch.stack([t[r] for t in table])[entry, :, cols].t()
                              for r in range(first - n_acc)]
        used = idx != 0
        run(step, used, inf, base_inf)
        inf = torch.where(used, inf & base_inf, inf)
    return lanes.acc_of(step, slots), inf


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lane_model_window_kernel_matches_plain(group):
    """8 bits (two windows, zero windows included) at 4 rows, a None base
    among them: digit- and inf-exact, garbage digits of the ∞ row too."""
    rng = random.Random(73 if group == "g1" else 74)
    pts = _points(group, rng, 3) + [None]
    pt, ops = _device(group, pts)
    bits = torch.from_numpy(F.bits_batch([0x5A, 0x07, 0xF0, 0x31], 8))
    base_inf = torch.tensor([p is None for p in pts])
    ref, ref_inf = G.scalar_mul_lazy_window_plain(ops, pt, bits, base_inf)
    got, got_inf = lane_window(group, pt, bits, base_inf)
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
