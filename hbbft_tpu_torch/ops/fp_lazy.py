"""Kernel 1: the lazy BLS12-381 field multiply, and its plain version.

Counterpart of ``hbbft_tpu/ops/pallas_fp.py`` (``fp_mul_lazy_pallas``, the
JAX package's only Pallas kernel, and its body ``mul_lazy_cols``).  Same
math in the same ``(NL=30, R)`` column layout: a 30×30 schoolbook
convolution into 61 digits, 3 rough-carry passes, a fold of the digits
≥ 2^390 against the 31 ``_FOLD_HI`` residue rows, then 4 squeeze rounds.
The output digits lie in [0, 2^13] and are ≡ a·b (mod p).

:func:`fp_mul_lazy` launches ``csrc/fp_mul_lazy.cu`` on a CUDA tensor (or
raises) and runs :func:`mul_lazy_cols` on a CPU tensor.  Both are
digit-exact with the reference: int32 throughout with exactly its carry
passes.
"""

from __future__ import annotations

import torch

from hbbft_tpu_torch import _build
from hbbft_tpu_torch.ops import fp381 as F

NL = F.NL


_KIDX: dict = {}


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook convolution over (2·NL+1, R): t[i+j] = Σ a[i]·b[j], as
    one outer product scattered onto its anti-diagonals."""
    dev = a.device
    kidx = _KIDX.get(dev)
    if kidx is None:
        ij = torch.arange(NL, device=dev)
        kidx = _KIDX[dev] = (ij[:, None] + ij[None, :]).reshape(-1)
    outer = (a[:, None, :] * b[None, :, :]).reshape(NL * NL, a.shape[1])
    t = torch.zeros((2 * NL + 1, a.shape[1]), dtype=torch.int32, device=dev)
    return t.index_add_(0, kidx, outer)


def _fold_hi(t: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """Fold digit positions ≥ NL against the 2^(13 j) mod p rows (every
    partial sum stays < 2^31, so the int32 result is exact)."""
    hi = (t[NL:, None, :] * fold[:, :, None]).sum(dim=0)
    return t[:NL] + hi.to(torch.int32)


def mul_lazy_cols(a: torch.Tensor, b: torch.Tensor, fold: torch.Tensor):
    """Plain PyTorch lazy modular product, ``(NL, R)`` columns."""
    return F._squeeze_lazy(_fold_hi(F._carry_rough(_conv(a, b)), fold))


def fp_mul_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy field multiply of int32 ``(NL, R)`` columns.

    On a CUDA tensor: one launch of Kernel 1 (one warp per row).  On a
    CPU tensor: :func:`mul_lazy_cols`."""
    fold = F.consts(a.device).fold
    if not a.is_cuda:
        return mul_lazy_cols(a, b, fold)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("fp_mul_lazy takes int32 limb columns")
    if a.shape != b.shape or a.dim() != 2 or a.shape[0] != NL:
        raise ValueError(f"fp_mul_lazy shapes {tuple(a.shape)} × {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError("fp_mul_lazy operands on different devices")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    R = a.shape[1]
    if R:
        lib = _build.lib("fp_mul_lazy")
        rc = lib.hb_fp_mul_lazy(
            a.data_ptr(), b.data_ptr(), fold.data_ptr(), out.data_ptr(), R,
            _build.stream_ptr(a),
        )
        _build.check("fp_mul_lazy", rc)
        _build.count("fp_mul_lazy")
    return out
