#!/usr/bin/env python3
"""Drive the PyTorch port of the HoneyBadger epoch on one NVIDIA card.

    python3 chip_smoke.py            # build, kernel checks, N = 64 epoch

Phases, one JSON line each; any failure exits non-zero:

1. ``build``: nvcc builds both kernels from ``hbbft_tpu_torch/csrc`` for
   sm_90a (one nvcc per source, started together) while the native BLS
   oracle builds beside them.
2. ``kernel_fp_mul_lazy``: Kernel 1 against its plain PyTorch version on
   the card, digit-exact, at the ladder's row counts (G2: 128, G1: 256,
   stacked Fp2 products: 384), at 1, 63 and 8192 rows.
3. ``kernel_sha3``: Kernel 2 against its plain version and hashlib,
   byte-exact, over message lengths 0 … 64 KiB and batches up to 4096,
   including the epoch's own shapes (4096 Merkle leaves of one shard each,
   2048 interior pairs of 64 bytes).
4. ``epoch``: one HoneyBadger epoch at N = 64 (f = 21, 64 000-byte
   contributions) with the TPKE encrypt ladders on the card, run twice;
   the second run is timed with every kernel's launch counter reset just
   before it and read just after.
5. ``profile``: the device's busy share (kernel time from torch.profiler
   over wall time), over 4 of the encrypt ladders' 132 steps and over
   ACS + decrypt.
6. ``kernels``: every kernel with its launches, errors and times.

Then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
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

# int32 operations per row of Kernel 1: the 30×30 convolution (900
# multiply-adds), 3 carry passes over 61 digits (3 ops a digit), the fold
# of 31 digits against 30-limb rows (930 multiply-adds), the squeeze's
# carries over 31 digits and its 4 rounds of 30 multiply-adds + carries.
FP_OPS_PER_ROW = 2 * 900 + 3 * 61 * 3 + 2 * 930 + 3 * 31 * 3 + 4 * (2 * 30 + 3 * 31 * 3)
FP_BYTES_PER_ROW = 3 * 30 * 4
# 32-bit operations per 136-byte SHA3 block: 24 rounds of ~213 64-bit lane
# operations (θ 65, ρπ 72, χ 75, ι 1), each two 32-bit operations, plus
# the 17-lane absorb.
SHA3_OPS_PER_BLOCK = 24 * 213 * 2 + 17

N_NODES = 64
CONTRIB_BYTES = 64000


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

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    batch, detail = ep.run(contribs, random.Random(12), timer=time.perf_counter)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if batch != contribs:
        raise AssertionError("timed epoch did not return every contribution")
    if not np.asarray(detail["accepted"]).all():
        raise AssertionError("a node did not accept every instance")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the epoch")
    ctx["launches"] = launches
    ctx["epoch_s"] = epoch_s
    ctx["epoch"] = (ep, payloads)
    return {
        "n": N_NODES, "f": nets[0].num_faulty(), "contribution_bytes": CONTRIB_BYTES,
        "payload_bytes": detail["payload_bytes"], "epoch_s": epoch_s,
        "phase_s": detail["phase_s"], "aba_epochs": detail["epochs"],
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
    ours = [e for e in kernels if e not in top
            and ("fp_mul_lazy_kernel" in e.key or "sha3_256_kernel" in e.key)]
    return {
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": None if busy is None else 1 - busy / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:72], "device_ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top + ours],
    }


def phase_profile(ctx):
    """Device busy share of the epoch's two parts: the encrypt ladders (4
    of their 132 steps, at the epoch's row counts — every step issues the
    same launches) and ACS + decrypt in full."""
    import torch

    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.ops import gcurve as G

    ep, payloads = ctx["epoch"]
    dev = torch.device("cuda")
    rng = random.Random(5)
    steps = 4
    out = {}
    for group, rows in (("g1", 2 * 2 * N_NODES), ("g2", 2 * N_NODES)):
        if group == "g1":
            pt = G.g1_to_device([c.g1_mul(c.G1_GEN, rng.randrange(1, c.R))
                                 for _ in range(rows)], dev)
            ops = G.LAZY_FP_OPS
        else:
            pt = G.g2_to_device([c.g2_mul(c.G2_GEN, rng.randrange(1, c.R))
                                 for _ in range(rows)], dev)
            ops = G.LAZY_FP2_OPS
        bits = torch.ones((rows, steps), dtype=torch.int32, device=dev)
        inf = torch.zeros((rows,), dtype=torch.bool, device=dev)
        out[f"ladder_{group}"] = {
            "rows": rows, "steps": steps,
            **_busy_share(torch, lambda: G.scalar_mul_lazy(ops, pt, bits, inf)),
        }
    out["acs_decrypt"] = _busy_share(torch, lambda: ep.run_from_payloads(payloads))
    return out


def phase_kernels(ctx):
    fp_main = ctx["fp"]["rows"][256]
    sha = ctx["sha3"]["shapes"][ctx["sha3"]["main"]]
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
              ("kernel_sha3", phase_kernel_sha3), ("epoch", phase_epoch),
              ("profile", phase_profile)]
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
