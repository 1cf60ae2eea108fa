"""The whole-ladder kernels: one launch runs a lazy scalar-mul ladder.

Counterpart of ``hbbft_tpu/ops/gcurve.py :: scalar_mul_lazy`` — on the TPU
one XLA program (a ``jax.lax.fori_loop`` over point_double, point_add_raw,
three point_selects and the infinity flag) around the lazy multiply that
``hbbft_tpu/ops/pallas_fp.py`` writes as a Pallas kernel.  Here it is one
launch of ``csrc/ladder_lazy.cu``: one block of warps per row (3 for G1, 8
for G2) running the step's independent field operations side by side from
the static schedule of :mod:`hbbft_tpu_torch.ops.ladder_schedule`, every
step on chip, the lazy field from ``csrc/fp_lazy.cuh``.  Digit-exact and
inf-exact with
:func:`hbbft_tpu_torch.ops.gcurve.scalar_mul_lazy_plain`, its plain version,
which :func:`hbbft_tpu_torch.ops.gcurve.scalar_mul_lazy` runs on CPU
tensors.

The windowed ladder (``gcurve.scalar_mul_lazy_window``: a table of 15
multiples, then 4 doubles and one table addition a window) is the second
kernel, ``csrc/ladder_window.cu``, on the same step machinery
(``csrc/ladder_steps.cuh``) with K rows a block (K = 1, 2 or 4; the
field of ``csrc/fp_lazy.cuh`` at K elements a warp): :func:`ladder_window`
at the K the kernel picks for the batch (:func:`window_k`),
:func:`ladder_window_k` at a given K, :func:`window_info` the compiled
kernel's registers and occupancy, :func:`lazy_op_probe` one field
operation at K elements a warp on its own.
"""

from __future__ import annotations

import ctypes

import torch

from hbbft_tpu_torch import _build
from hbbft_tpu_torch.ops import fp381 as F

NL = F.NL
KS = (1, 2, 4)  # the windowed kernel's rows a block


def ladder_lazy(pt, bits: torch.Tensor, base_inf: torch.Tensor, fp2: bool):
    """One launch of the bitwise whole-ladder kernel on CUDA tensors.

    pt: (X, Y, Z), each int32 (NL, R) (G1) or (NL, 2R) [re | im] (G2,
    ``fp2=True``); bits: (R, nbits) bool/int, little-endian; base_inf: bool
    (R,).  Returns ((X, Y, Z), inf) in the same layout."""
    return _launch("ladder_lazy", pt, bits, base_inf, fp2)


def ladder_window(pt, bits: torch.Tensor, base_inf: torch.Tensor, fp2: bool):
    """One launch of the 4-bit windowed whole-ladder kernel
    (``csrc/ladder_window.cu``) on CUDA tensors, digit- and inf-exact with
    :func:`hbbft_tpu_torch.ops.gcurve.scalar_mul_lazy_window_plain`.
    Arguments and result as :func:`ladder_lazy`; ``nbits`` must be a
    multiple of 4."""
    if bits.dim() == 2 and bits.shape[1] % 4:
        raise ValueError(f"ladder_window takes a multiple of 4 bits, not {bits.shape[1]}")
    return _launch("ladder_window", pt, bits, base_inf, fp2)


def ladder_window_k(pt, bits: torch.Tensor, base_inf: torch.Tensor, fp2: bool, k: int):
    """:func:`ladder_window` at K = ``k`` rows a block (1, 2 or 4)."""
    if k not in KS:
        raise ValueError(f"ladder_window_k: K is one of {KS}, not {k}")
    if bits.dim() == 2 and bits.shape[1] % 4:
        raise ValueError(f"ladder_window takes a multiple of 4 bits, not {bits.shape[1]}")
    return _launch("ladder_window", pt, bits, base_inf, fp2, k)


def _fn(name: str, argtypes):
    fn = getattr(_build.lib("ladder_window"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def window_k(rows: int, fp2: bool) -> int:
    """The K (rows a block) that ``ladder_window`` runs ``rows`` rows at."""
    return _fn("hb_ladder_window_pick", [ctypes.c_int, ctypes.c_int])(rows, int(fp2))


def window_info(k: int, fp2: bool) -> dict:
    """The windowed kernel at K = ``k``: registers a thread, spilled (local)
    bytes, blocks an SM, dynamic shared memory bytes, warps a block."""
    out = (ctypes.c_int * 5)()
    rc = _fn("hb_ladder_window_info", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])(
        k, int(fp2), ctypes.addressof(out))
    _build.check("ladder_window", rc)
    return dict(zip(("registers", "spilled_bytes", "blocks_per_sm", "smem_bytes", "warps"),
                    out))


def lazy_op_probe(kind: int, a: torch.Tensor, b: torch.Tensor, k: int,
                  reps: int = 1) -> torch.Tensor:
    """One lazy field operation (``kind``: 0 MUL, 1 ADD, 2 SUB, −1 none,
    which returns ``a``) at ``k`` elements a warp on CUDA (NL, R) int32
    columns, by the probe kernel of ``csrc/ladder_window.cu``, chained
    ``reps`` times (a ← a op b); no path runs it."""
    rows = [torch.nn.functional.pad(x.t(), (0, 32 - NL)).contiguous() for x in (a, b)]
    out = torch.empty_like(rows[0])
    if out.shape[0]:
        c = F.consts(a.device)
        rc = _fn("hb_lazy_op_probe", [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 +
                 [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])(
            k, kind, rows[0].data_ptr(), rows[1].data_ptr(), out.data_ptr(), c.fold.data_ptr(),
            c.subc.data_ptr(), out.shape[0], reps, _build.stream_ptr(a))
        _build.check("ladder_window", rc)
    return out[:, :NL].t().contiguous()


def _launch(name: str, pt, bits: torch.Tensor, base_inf: torch.Tensor, fp2: bool,
            k: int | None = None):
    x, y, z = pt
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors (the plain ladders are "
                         "gcurve.scalar_mul_lazy_plain and scalar_mul_lazy_window_plain)")
    if bits.dim() != 2:
        raise ValueError(f"{name} bits shape {tuple(bits.shape)}: expected (R, nbits)")
    R, nbits = bits.shape
    width = 2 * R if fp2 else R
    for c in pt:
        if c.dtype != torch.int32 or tuple(c.shape) != (NL, width):
            raise ValueError(
                f"{name} coordinate {c.dtype} {tuple(c.shape)}: expected "
                f"int32 ({NL}, {width})"
            )
    if tuple(base_inf.shape) != (R,):
        raise ValueError(f"{name} base_inf shape {tuple(base_inf.shape)}: expected ({R},)")
    if any(t.device != dev for t in (y, z, bits, base_inf)):
        raise ValueError(f"{name} operands on different devices")
    x, y, z = (c.contiguous() for c in pt)
    bits = bits.to(torch.int32).contiguous()
    base_inf = base_inf.to(torch.bool).contiguous()
    out = tuple(torch.empty_like(c) for c in (x, y, z))
    inf = torch.empty((R,), dtype=torch.bool, device=dev)
    if R:
        c = F.consts(dev)
        args = (x.data_ptr(), y.data_ptr(), z.data_ptr(), bits.data_ptr(),
                base_inf.data_ptr(), c.fold.data_ptr(), c.subc.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                inf.data_ptr(), R, nbits, int(fp2))
        if k is None:
            rc = getattr(_build.lib(name), _build.KERNELS[name][1])(*args, _build.stream_ptr(x))
        else:
            rc = _fn("hb_ladder_window_k", _build.KERNELS[name][2][:-1] + [ctypes.c_int,
                                                                        ctypes.c_void_p])(
                *args, k, _build.stream_ptr(x))
        _build.check(name, rc)
        _build.count(name)
    return out, inf
