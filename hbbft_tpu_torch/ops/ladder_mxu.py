"""The windowed ladder over the 8-bit-digit field, one launch on the card.

Counterpart of ``hbbft_tpu/ops/gcurve.py :: scalar_mul_lazy_window`` over
``MXU_FP_OPS`` / ``MXU_FP2_OPS`` (on the TPU one XLA program, whose field
products, ``hbbft_tpu/ops/fp381_mxu.py :: fp_mul``, are two matmuls on the
matrix unit).  Here it is one launch of ``csrc/ladder_mxu.cu``: the 13-bit
windowed kernel's design (``csrc/ladder_steps.cuh``: several warps a row
on the static step tables, K rows a block) over the 8-bit field of
``csrc/fp_mxu.cuh``, each product's digit convolution and the K rows'
shared fold as ``mma.sync`` f16 products on the tensor cores, the carries
and squeezes on the ALU.  Digit-exact and inf-exact with
:func:`hbbft_tpu_torch.ops.gcurve.scalar_mul_lazy_window_plain` over
:mod:`hbbft_tpu_torch.ops.fp381_mxu`, its plain version, which
:func:`hbbft_tpu_torch.ops.gcurve.scalar_mul_lazy_window` runs on CPU
tensors.

:func:`ladder_mxu` runs at the K the kernel picks for the batch
(:func:`mxu_k`), :func:`ladder_mxu_k` at a given K; :func:`fold_fragments`
lays the fold matrix out as the kernel's A fragments; :func:`info` reports
the compiled kernel's registers and occupancy and the K thresholds.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hbbft_tpu_torch import _build
from hbbft_tpu_torch.ops import fp381_mxu as M
from hbbft_tpu_torch.ops.rs import device_key

NL = M.NL
KS = (1, 2, 4)  # rows a block
TILE = 16  # the m16n8k16 tile's rows and depth
FOLD_TILES = 4  # the fold matrix, 64 × 64 padded: 4 m-tiles × 4 k-steps


def fold_matrix() -> np.ndarray:
    """(64, 64) float32: row d, column m holds digit d of 2^(8(NL+m)) mod p
    (the reference's ``_FOLD_ROWS`` transposed), zero-padded."""
    out = np.zeros((FOLD_TILES * TILE, FOLD_TILES * TILE), dtype=np.float32)
    out[:NL, :M._N_HI] = M._FOLD_ROWS.T
    return out


def fold_fragments() -> np.ndarray:
    """The fold matrix as the A fragments of ``mma.m16n8k16.row`` (f16):
    uint32 ``[m-tile][k-step][lane][4]``, register j of lane (g = lane / 4,
    t = lane % 4) the f16 pair at row 16·mt + g + 8·(j & 1), columns
    16·ks + 2t + 8·(j >> 1) and one more (the lower column in the low half)."""
    f16 = fold_matrix().astype(np.float16)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((FOLD_TILES, FOLD_TILES, 32, 4), dtype=np.uint32)
    for mt in range(FOLD_TILES):
        for ks in range(FOLD_TILES):
            for j in range(4):
                r = TILE * mt + g + 8 * (j & 1)
                c = TILE * ks + 2 * t + 8 * (j >> 1)
                lo = f16[r, c].view(np.uint16).astype(np.uint32)
                hi = f16[r, c + 1].view(np.uint16).astype(np.uint32)
                out[mt, ks, :, j] = lo | (hi << 16)
    return out


class _Consts:
    """The kernel's constant operands on one device, int32: the fold
    fragments, the squeeze rows (3, NL), the sub constant (NL,)."""

    def __init__(self, device):
        def col(a):
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

        self.frag = col(fold_fragments().reshape(-1))
        self.sq = col(M._SQUEEZE_ROWS.astype(np.int32))
        self.subc = col(M._SUBC_LIMBS.astype(np.int32))


_CONSTS: dict = {}


def _consts(device) -> _Consts:
    """The constants on ``device``, one copy a device however it is spelled
    (``"cuda"``, ``cuda:0``: :func:`hbbft_tpu_torch.ops.rs.device_key`)."""
    key = device_key(device)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = _Consts(key)
    return hit


def ladder_mxu(pt, bits: torch.Tensor, base_inf: torch.Tensor, fp2: bool):
    """One launch of the windowed ladder kernel over the 8-bit field on
    CUDA tensors, at the K (rows a block) it picks for the batch.

    pt: (X, Y, Z), each int32 (NL, R) (G1) or (NL, 2R) [re | im] (G2,
    ``fp2=True``), digits in [0, 256]; bits: (R, nbits) bool/int,
    little-endian, nbits a multiple of 4; base_inf: bool (R,).  Returns
    ((X, Y, Z), inf) in the same layout."""
    return _launch(pt, bits, base_inf, fp2, None)


def ladder_mxu_k(pt, bits: torch.Tensor, base_inf: torch.Tensor, fp2: bool, k: int):
    """:func:`ladder_mxu` at K = ``k`` rows a block (1, 2 or 4)."""
    if k not in KS:
        raise ValueError(f"ladder_mxu_k: K is one of {KS}, not {k}")
    return _launch(pt, bits, base_inf, fp2, k)


def _fn(name: str, argtypes):
    fn = getattr(_build.lib("ladder_mxu"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def mxu_k(rows: int, fp2: bool) -> int:
    """The K (rows a block) that ``ladder_mxu`` runs ``rows`` rows at."""
    return _fn("hb_ladder_mxu_pick", [ctypes.c_int, ctypes.c_int])(rows, int(fp2))


def _launch(pt, bits: torch.Tensor, base_inf: torch.Tensor, fp2: bool, k):
    x, y, z = pt
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("ladder_mxu runs on CUDA tensors (the plain ladder is "
                         "gcurve.scalar_mul_lazy_window_plain over MXU_FP_OPS / MXU_FP2_OPS)")
    if bits.dim() != 2:
        raise ValueError(f"ladder_mxu bits shape {tuple(bits.shape)}: expected (R, nbits)")
    R, nbits = bits.shape
    if nbits % 4:
        raise ValueError(f"ladder_mxu takes a multiple of 4 bits, not {nbits}")
    width = 2 * R if fp2 else R
    for c in pt:
        if c.dtype != torch.int32 or tuple(c.shape) != (NL, width):
            raise ValueError(f"ladder_mxu coordinate {c.dtype} {tuple(c.shape)}: expected "
                             f"int32 ({NL}, {width})")
    if tuple(base_inf.shape) != (R,):
        raise ValueError(f"ladder_mxu base_inf shape {tuple(base_inf.shape)}: expected ({R},)")
    if any(t.device != dev for t in (y, z, bits, base_inf)):
        raise ValueError("ladder_mxu operands on different devices")
    x, y, z = (c.contiguous() for c in pt)
    bits = bits.to(torch.int32).contiguous()
    base_inf = base_inf.to(torch.bool).contiguous()
    out = tuple(torch.empty_like(c) for c in (x, y, z))
    inf = torch.empty((R,), dtype=torch.bool, device=dev)
    if R:
        c = _consts(dev)
        args = (x.data_ptr(), y.data_ptr(), z.data_ptr(), bits.data_ptr(), base_inf.data_ptr(),
                c.frag.data_ptr(), c.sq.data_ptr(), c.subc.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), inf.data_ptr(), R, nbits, int(fp2))
        if k is None:
            rc = _build.lib("ladder_mxu").hb_ladder_mxu(*args, _build.stream_ptr(x))
        else:
            rc = _fn("hb_ladder_mxu_k", _build.KERNELS["ladder_mxu"][2][:-1]
                     + [ctypes.c_int, ctypes.c_void_p])(*args, k, _build.stream_ptr(x))
        _build.check("ladder_mxu", rc)
        _build.count("ladder_mxu")
    return out, inf


def info(fp2: bool, k: int) -> dict:
    """The compiled kernel (G2 when ``fp2``) at K = ``k``: registers a
    thread, spilled (local) bytes, blocks an SM, dynamic shared memory
    bytes, warps a block, and the rows from which :func:`mxu_k` picks K = 2
    and K = 4 (None: never)."""
    out = (ctypes.c_int * 7)()
    rc = _fn("hb_ladder_mxu_info", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])(
        k, int(fp2), ctypes.addressof(out))
    _build.check("ladder_mxu", rc)
    got = dict(zip(("registers", "spilled_bytes", "blocks_per_sm", "smem_bytes", "warps",
                    "k2_from_rows", "k4_from_rows"), out))
    for key in ("k2_from_rows", "k4_from_rows"):
        got[key] = got[key] or None  # 0: never
    return got
