#!/usr/bin/env python3
"""Drive the PyTorch port of the HoneyBadger epoch on one NVIDIA card.

    python3 chip_smoke.py            # build, kernel checks, N = 64 epochs

Phases, one JSON line each; any failure exits non-zero:

1. ``build``: nvcc builds the three kernels from ``hbbft_tpu_torch/csrc``
   for sm_90a (one nvcc per source, started together) while the native BLS
   oracle builds beside them.
2. ``kernel_fp_mul_lazy``: Kernel 1 (the warp-per-row lazy multiply)
   against its plain PyTorch version on the card, digit-exact, at 1, 63,
   128, 256, 384 and 8192 rows.
3. ``kernel_sha3``: Kernel 2 against its plain version and hashlib,
   byte-exact, over message lengths 0 … 64 KiB and batches up to 4096,
   including the epoch's own shapes (4096 Merkle leaves of one shard each,
   2048 interior pairs of 64 bytes).
4. ``kernel_ladder``: the whole-ladder kernel against the plain stepwise
   ladder on the card (plain multiply, no kernel), digit-exact and
   inf-exact, at the epoch's shapes (G1: 256 rows, G2: 128 rows, 132 bits)
   with edge rows (a zero scalar, all-ones bits, base_inf padding), and
   against the native oracle's affine points on five rows.
5. ``epoch``: HoneyBadger epochs at N = 64 (f = 21, 64 000-byte
   contributions) with the TPKE encrypt ladders on the card: a warm run
   whose ciphertexts are held against the native oracle's, then 5 timed
   runs, each with every kernel's launch counter reset just before it and
   read just after (the ladder kernel 2 launches, SHA3 21, Kernel 1 none).
6. ``profile``: the device's busy share (kernel time from torch.profiler
   over wall time) and kernel launches, over the whole encrypt phase and
   over ACS + decrypt.
7. ``kernels``: every kernel with its launches, errors and times.

Then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the float32 rate
# outside the tensor cores, taken as the ceiling for 32-bit integer work
# (a multiply-add counts as two operations).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# int32 operations of the lazy field, per row.  The squeeze: 3 carry
# passes over 31 digits (3 ops a digit), then 4 rounds of 30 multiply-adds
# and 3 carry passes.  Kernel 1: the 30×30 convolution (900 multiply-adds),
# 3 carry passes over 61 digits, the fold of 31 digits against 30-limb rows
# (930 multiply-adds), the squeeze.  The add: 1 op a digit and the squeeze;
# the sub: 3 ops a digit (2·MASK − b, + a, + constant) and the squeeze; a
# select: 1 op a digit.
SQUEEZE_OPS = 3 * 31 * 3 + 4 * (2 * 30 + 3 * 31 * 3)
FP_OPS_PER_ROW = 2 * 900 + 3 * 61 * 3 + 2 * 930 + SQUEEZE_OPS
FP_BYTES_PER_ROW = 3 * 30 * 4
FP_ADD_OPS = 30 + SQUEEZE_OPS
FP_SUB_OPS = 3 * 30 + SQUEEZE_OPS
FP_SELECT_OPS = 30
# Fp operations of one ladder step (point_double + point_add_raw + the 3
# point selects).  G1: 23 products, 15 adds, 10 subs, 9 selects.  G2, in Fp
# terms: 14 Karatsuba products (3 products, 3 adds, 2 subs each), 9 squares
# (2 products, 2 adds, 1 sub each), 15 adds and 10 subs (2 each), 9 selects
# (2 each).
LADDER_STEP_OPS = {
    "g1": 23 * FP_OPS_PER_ROW + 15 * FP_ADD_OPS + 10 * FP_SUB_OPS + 9 * FP_SELECT_OPS,
    "g2": (14 * 3 + 9 * 2) * FP_OPS_PER_ROW + (14 * 3 + 9 * 2 + 15 * 2) * FP_ADD_OPS
    + (14 * 2 + 9 + 10 * 2) * FP_SUB_OPS + 18 * FP_SELECT_OPS,
}
LADDER_BITS = 132  # the GLV/GLS half-scalar ladders of crypto/batch.py
# 32-bit operations per 136-byte SHA3 block: 24 rounds of ~213 64-bit lane
# operations (θ 65, ρπ 72, χ 75, ι 1), each two 32-bit operations, plus
# the 17-lane absorb.
SHA3_OPS_PER_BLOCK = 24 * 213 * 2 + 17

N_NODES = 64
CONTRIB_BYTES = 64000
TIMED_EPOCHS = 5
# launches of each kernel in one epoch: one G1 and one G2 ladder (64
# proposers fit one encrypt chunk), 21 SHA3 batches (Merkle leaf level + 6
# interior levels, for the commit, the proof checks and the root check);
# Kernel 1 runs inside the ladder kernel, never on its own
EPOCH_LAUNCHES = {"ladder_lazy": 2, "sha3_256": 21, "fp_mul_lazy": 0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls,
    per call, after one warm call."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    samples.sort()
    return samples[len(samples) // 2]


def device_ms_per_launch(torch, fn, kernel: str, calls: int = 20):
    """Device time of one launch of ``kernel`` (a substring of its name),
    from torch.profiler over ``calls`` calls of ``fn``; None when the
    profiler records no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key and e.count]
    if not hits:
        return None
    return sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits) / 1e3


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- phases


def phase_build(ctx):
    from hbbft_tpu_torch import _build

    native = {}

    def build_native():
        t0 = time.perf_counter()
        from hbbft_tpu_torch.native import get_oracle

        get_oracle()
        native["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    th.start()
    built = _build.build_all(force=True)
    th.join()
    for name in _build.KERNELS:
        _build.lib(name)
    if "seconds" not in native:
        raise RuntimeError("native oracle build failed")
    return {
        "seconds": time.perf_counter() - t0,
        "nvcc": {k: {"seconds": v["seconds"], "ptxas": v["ptxas"]} for k, v in built.items()},
        "native_oracle_seconds": native["seconds"],
        "smi": ctx["smi"],
    }


def phase_kernel_fp(ctx):
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import fp_lazy

    dev = torch.device("cuda")
    fold = F.consts(dev).fold
    rng = np.random.default_rng(1)
    rows = {}
    max_err = 0
    for R in (1, 63, 128, 256, 384, 8192):
        a = rng.integers(0, (1 << 13) + 1, (F.NL, R)).astype(np.int32)
        b = rng.integers(0, (1 << 13) + 1, (F.NL, R)).astype(np.int32)
        a[:, 0] = b[:, 0] = 1 << 13
        ta = torch.from_numpy(a).to(dev)
        tb = torch.from_numpy(b).to(dev)
        got = fp_lazy.fp_mul_lazy(ta, tb)
        ref = fp_lazy.mul_lazy_cols(ta, tb, fold)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"fp_mul_lazy differs from its plain version at R={R}")
        ms = time_ms(torch, lambda: fp_lazy.fp_mul_lazy(ta, tb), 200)
        plain_ms = time_ms(torch, lambda: fp_lazy.mul_lazy_cols(ta, tb, fold), 20)
        bms, by = bound_ms(FP_BYTES_PER_ROW * R, FP_OPS_PER_ROW * R)
        rows[R] = {"ms": ms, "us": ms * 1e3, "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by}
        if R in (256, 8192):  # the timing loop is bound by host dispatch
            rows[R]["device_ms_per_launch"] = device_ms_per_launch(
                torch, lambda: fp_lazy.fp_mul_lazy(ta, tb), "fp_mul_lazy_kernel")
    ctx["fp"] = {"max_abs_err": max_err, "rows": rows}
    return {"max_abs_err": max_err, "tolerance": 0, "digit_exact": True, "by_rows": rows}


def phase_kernel_sha3(ctx):
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import keccak

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    checked = []
    max_err = 0

    def check(msgs, t):
        """Kernel 2 on ``t`` against its plain version on the same tensor
        (every row, exact) and against hashlib (three rows)."""
        nonlocal max_err
        M, L = msgs.shape
        got = keccak.sha3_256(t)
        ref = keccak.sha3_256_plain(t)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"sha3 kernel differs from its plain version at {M}x{L}")
        got_h = got.cpu().numpy()
        for i in sorted({0, M // 2, M - 1}):
            if got_h[i].tobytes() != hashlib.sha3_256(msgs[i].tobytes()).digest():
                raise AssertionError(f"sha3 kernel differs from hashlib at {M}x{L}")
        checked.append([L, M])

    leaf = ctx["leaf_bytes"]
    for L, batches in ((0, (1, 4096)), (64, (1, 2048)), (135, (1, 4096)),
                       (136, (1, 4096)), (137, (1, 4096)), (leaf, (1, 4096)),
                       (2930, (1, 4096)), (65536, (1, 512))):
        for M in batches:
            msgs = rng.integers(0, 256, (M, L), dtype=np.uint8)
            check(msgs, torch.from_numpy(msgs).to(dev))
    # times at the epoch's shapes: the 4096 Merkle leaves of one RBC round
    # and the 2048 pairs of its first interior level, each checked again on
    # the very tensor that is timed
    shapes = {}
    for M, L in ((4096, leaf), (2048, 64)):
        msgs = rng.integers(0, 256, (M, L), dtype=np.uint8)
        t = torch.from_numpy(msgs).to(dev)
        check(msgs, t)
        ms = time_ms(torch, lambda: keccak.sha3_256(t), 20)
        plain_ms = time_ms(torch, lambda: keccak.sha3_256_plain(t), 1, rounds=3)
        nblocks = L // keccak.RATE_BYTES + 1
        bms, by = bound_ms(M * (L + 32), M * nblocks * SHA3_OPS_PER_BLOCK)
        shapes[f"{M}x{L}"] = {"ms": ms, "us": ms * 1e3, "plain_ms": plain_ms,
                              "bound_ms": bms, "bound_by": by}
    ctx["sha3"] = {"max_abs_err": max_err, "shapes": shapes,
                   "main": f"4096x{ctx['leaf_bytes']}"}
    return {"max_abs_err": max_err, "tolerance": 0, "byte_exact": True, "checked": checked,
            "by_shape": shapes}


def _ladder_rows(group: str, rows: int, rng, dev):
    """The epoch's ladder shape with edge rows: row 0 a zero scalar, row 1
    all-ones bits, the last two rows base_inf padding, the rest random
    half-scalars (< 2^128) on random multiples of the generator."""
    import torch

    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import gcurve as G

    n_pad = 2
    if group == "g1":
        pts = [c.g1_mul(c.G1_GEN, rng.randrange(1, c.R)) for _ in range(rows - n_pad)]
        to_dev = G.g1_to_device
    else:
        pts = [c.g2_mul(c.G2_GEN, rng.randrange(1, c.R)) for _ in range(rows - n_pad)]
        to_dev = G.g2_to_device
    pts += [None] * n_pad
    scalars = [0, (1 << LADDER_BITS) - 1] + [rng.getrandbits(128) for _ in range(rows - 2)]
    bits = torch.from_numpy(F.bits_batch(scalars, LADDER_BITS)).to(dev)
    base_inf = torch.tensor([p is None for p in pts], device=dev)
    return pts, scalars, to_dev(pts, dev), bits, base_inf


def phase_kernel_ladder(ctx):
    import torch

    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.native import get_oracle
    from hbbft_tpu_torch.ops import gcurve as G

    dev = torch.device("cuda")
    nat = get_oracle()
    rng = random.Random(4)
    groups = {}
    max_err = 0
    for group, rows in (("g1", 4 * N_NODES), ("g2", 2 * N_NODES)):
        if group == "g1":
            ops = G.LAZY_FP_OPS
            from_dev, to_bytes, oracle_mul = G.g1_from_device_batch, c.g1_to_bytes, nat.bls_g1_mul
        else:
            ops = G.LAZY_FP2_OPS
            from_dev, to_bytes, oracle_mul = G.g2_from_device_batch, c.g2_to_bytes, nat.bls_g2_mul
        pts, scalars, pt, bits, base_inf = _ladder_rows(group, rows, rng, dev)
        out, inf = G.scalar_mul_lazy(ops, pt, bits, base_inf)
        torch.cuda.synchronize()
        # the plain stepwise ladder, timed once: it is the reference
        t0 = time.perf_counter()
        ref, ref_inf = G.scalar_mul_lazy_plain(ops, pt, bits, base_inf)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(out, ref))
        max_err = max(max_err, err)
        if err or not torch.equal(inf, ref_inf):
            raise AssertionError(f"{group} ladder kernel differs from the plain ladder")
        inf_h = inf.cpu().tolist()
        want_inf = [s == 0 or p is None for p, s in zip(pts, scalars)]
        if inf_h != want_inf:
            raise AssertionError(f"{group} ladder kernel: wrong infinity rows")
        host = from_dev(out)
        checked = sorted({0, 1, 2, rows // 2, rows - 1})
        for i in checked:
            got = to_bytes(None if inf_h[i] else host[i])
            want = to_bytes(None) if pts[i] is None else oracle_mul(to_bytes(pts[i]), scalars[i])
            if got != want:
                raise AssertionError(f"{group} ladder kernel differs from the native oracle, row {i}")
        ms = time_ms(torch, lambda: G.scalar_mul_lazy(ops, pt, bits, base_inf), 5, rounds=3)
        width = out[0].shape[1]
        n_bytes = 2 * 3 * 30 * width * 4 + rows * LADDER_BITS * 4 + 2 * rows
        n_ops = rows * LADDER_BITS * LADDER_STEP_OPS[group]
        bms, by = bound_ms(n_bytes, n_ops)
        groups[group] = {"rows": rows, "bits": LADDER_BITS, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bms, "bound_by": by, "bytes": n_bytes, "ops": n_ops,
                         "oracle_rows": checked}
    both = bound_ms(sum(g["bytes"] for g in groups.values()),
                    sum(g["ops"] for g in groups.values()))
    ctx["ladder"] = {
        "max_abs_err": max_err,
        "ms": sum(g["ms"] for g in groups.values()),
        "plain_ms": sum(g["plain_ms"] for g in groups.values()),
        "bound_ms": both[0], "bound_by": both[1],
    }
    return {"max_abs_err": max_err, "tolerance": 0, "digit_exact": True, "inf_exact": True,
            "by_group": groups}


def phase_epoch(ctx):
    import numpy as np
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    ids = list(range(N_NODES))
    nets = NetworkInfo.generate_map(ids, random.Random(7))
    rng = np.random.default_rng(3)
    contribs = {i: rng.integers(0, 256, CONTRIB_BYTES, dtype=np.uint8).tobytes() for i in ids}
    ep = BatchedHoneyBadgerEpoch(nets, device="cuda", encrypt_backend="device")

    # warm run, split so its ciphertexts can be held against the native
    # oracle's encrypt under the same scalars; that reference encrypt runs
    # between the two timed halves and is not part of warm_epoch_s
    t0 = time.perf_counter()
    payloads = ep.encrypt_phase(contribs, random.Random(11))
    torch.cuda.synchronize()
    warm_encrypt_s = time.perf_counter() - t0
    pk = nets[0].public_key_set().public_key()
    native = [
        ct.to_bytes() for ct in tc.tpke_encrypt_batch(
            pk, [contribs[i] for i in ep.ids], random.Random(11), backend="native",
            device="cpu",
        )
    ]
    if payloads != native:
        raise AssertionError("device-route ciphertexts differ from the native oracle's")
    t0 = time.perf_counter()
    batch, _ = ep.run_from_payloads(payloads)
    torch.cuda.synchronize()
    warm_s = warm_encrypt_s + time.perf_counter() - t0
    if batch != contribs:
        raise AssertionError("warm epoch did not return every contribution")

    timed = []
    for k in range(TIMED_EPOCHS):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        batch, detail = ep.run(contribs, random.Random(12 + k), timer=time.perf_counter)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if batch != contribs:
            raise AssertionError("timed epoch did not return every contribution")
        if not np.asarray(detail["accepted"]).all():
            raise AssertionError("a node did not accept every instance")
        if launches != EPOCH_LAUNCHES:
            raise AssertionError(f"epoch launches {launches}, expected {EPOCH_LAUNCHES}")
        timed.append({"epoch_s": epoch_s, "phase_s": detail["phase_s"],
                      "aba_epochs": detail["epochs"]})
    ctx["launches"] = launches
    ctx["epoch"] = (ep, payloads, contribs)
    return {
        "n": N_NODES, "f": nets[0].num_faulty(), "contribution_bytes": CONTRIB_BYTES,
        "payload_bytes": detail["payload_bytes"],
        "epoch_s_median": statistics.median(t["epoch_s"] for t in timed),
        "timed": timed,
        "warm_epoch_s": warm_s, "warm_encrypt_s": warm_encrypt_s,
        "launches_per_epoch": launches, "batch_ok": True,
        "ciphertexts_match_native": True,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def _busy_share(torch, fn):
    """Wall seconds of ``fn`` (timed bare, after a warm call), and the
    device-busy seconds of its kernels as torch.profiler records them in a
    second, profiled call (the profiler slows the host, not the kernels).
    Busy is None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 if kernels else None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    ours = [e for e in kernels if e not in top and any(
        k in e.key for k in ("ladder_lazy_kernel", "fp_mul_lazy_kernel", "sha3_256_kernel"))]
    return {
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": None if busy is None else 1 - busy / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:72], "device_ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top + ours],
    }


# the encrypt phase's stages, by function name: the ladder dispatches
# (host conversions, endomorphisms, the launch) and collections (the wait
# for the kernel, host adds), the affine serialisation, the KDF + XOR, the
# native hash-to-G2, the ciphertext's serialisation.  (cProfile on this
# Python drops some outer frames, so the stages are inner functions.)
ENCRYPT_STAGES = ("_mul_batch_dispatch", "_mul_batch_collect", "_g1_to_bytes_batch",
                  "_xor_mask", "bls_hash_g2_batch", "to_bytes")


def _host_profile(torch, fn, stages, n: int = 8):
    """One call of ``fn`` under cProfile (which slows Python calls, not
    native code): the cumulative seconds of each function named in
    ``stages``, and the ``n`` functions with the most own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats  # (file, line, name) → (cc, calls, own, cumulative, …)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return {
        "stages_s": {s: sum(v[3] for (_, _, name), v in stats.items() if name == s)
                     for s in stages},
        "top_own": [{"fn": f"{os.path.basename(f)}:{line}:{name}", "calls": v[1],
                     "own_s": v[2], "cumulative_s": v[3]} for (f, line, name), v in top],
    }


def phase_profile(ctx):
    """Device busy share and kernel launches of the epoch's two parts, each
    in full as the epoch runs it: the encrypt phase (both ladders, the
    host's hash-to-G2, KDF and serialisation) and ACS + decrypt; and the
    encrypt phase's host time by stage."""
    import torch

    ep, payloads, contribs = ctx["epoch"]

    def encrypt():
        return ep.encrypt_phase(contribs, random.Random(5))

    enc = _busy_share(torch, encrypt)
    if enc["kernel_launches"] >= 1000:
        raise AssertionError(f"encrypt phase issued {enc['kernel_launches']} launches")
    enc["host"] = _host_profile(torch, encrypt, ENCRYPT_STAGES)
    return {"encrypt": enc,
            "acs_decrypt": _busy_share(torch, lambda: ep.run_from_payloads(payloads))}


def phase_kernels(ctx):
    fp_main = ctx["fp"]["rows"][256]
    sha = ctx["sha3"]["shapes"][ctx["sha3"]["main"]]
    lad = ctx["ladder"]
    launches = ctx["launches"]
    kernels = [
        {
            "name": "fp_mul_lazy", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/fp_mul_lazy.cu",
            "replaces": "hbbft_tpu/ops/pallas_fp.py:116",
            "launches": launches["fp_mul_lazy"],
            "max_abs_err": ctx["fp"]["max_abs_err"],
            "ms": fp_main["ms"], "plain_ms": fp_main["plain_ms"],
            "bound_ms": fp_main["bound_ms"], "bound_by": fp_main["bound_by"],
            "library_ms": None,
        },
        {
            "name": "sha3_256", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/keccak.cu",
            "replaces": "hbbft_tpu/ops/keccak.py:284",
            "launches": launches["sha3_256"],
            "max_abs_err": ctx["sha3"]["max_abs_err"],
            "ms": sha["ms"], "plain_ms": sha["plain_ms"],
            "bound_ms": sha["bound_ms"], "bound_by": sha["bound_by"],
            "library_ms": None,
        },
        {
            "name": "ladder_lazy", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/ladder_lazy.cu",
            "replaces": "hbbft_tpu/ops/gcurve.py:245",
            "launches": launches["ladder_lazy"],
            "max_abs_err": lad["max_abs_err"],
            "ms": lad["ms"], "plain_ms": lad["plain_ms"],
            "bound_ms": lad["bound_ms"], "bound_by": lad["bound_by"],
            "library_ms": None,
            "shape": "the epoch's two launches summed: G1 256 rows + G2 128 rows, 132 bits",
        },
    ]
    return {"kernels": kernels}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import hbbft_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the hbbft_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2

    from hbbft_tpu_torch.parallel.rbc import _frame_shard_len

    ctx = {"smi": smi_line()}
    # shard bytes of the epoch's ciphertexts (294-byte TPKE header + body)
    ctx["leaf_bytes"] = _frame_shard_len([bytes(294 + CONTRIB_BYTES)], N_NODES - 2 * 21)
    phases = [("build", phase_build), ("kernel_fp_mul_lazy", phase_kernel_fp),
              ("kernel_sha3", phase_kernel_sha3), ("kernel_ladder", phase_kernel_ladder),
              ("epoch", phase_epoch), ("profile", phase_profile)]
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn(ctx)
            emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0, **res})
        except Exception as exc:  # report every phase, then fail
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(exc)})
            ok = False
            if name == "build":
                break
    if not ok:
        return 1
    emit(phase_kernels(ctx))
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
