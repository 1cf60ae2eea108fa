"""Batched Merkle trees over SHA3-256 digests (device path).

Counterpart of the device half of ``hbbft_tpu/ops/merkle.py``
(``merkle_build_jax``, ``merkle_root_jax``, ``merkle_verify_jax``).  Tree
shape: leaves are ``sha3_256(value)``; at every level pairs hash to
``sha3_256(left || right)`` and an odd trailing node is carried up
unchanged.  Every hash goes through :func:`hbbft_tpu_torch.ops.keccak.
sha3_256` — one kernel launch per tree level on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from hbbft_tpu_torch.ops.keccak import sha3_256


def _parents(level: torch.Tensor, width: int) -> torch.Tensor:
    """Hash adjacent pairs of a (..., width, 32) level; carry an odd tail."""
    pairs = width // 2
    left = level[..., 0: 2 * pairs: 2, :]
    right = level[..., 1: 2 * pairs: 2, :]
    parents = sha3_256(torch.cat([left, right], dim=-1))
    if width % 2 == 1:
        parents = torch.cat([parents, level[..., -1:, :]], dim=-2)
    return parents


def merkle_build(leaves: torch.Tensor):
    """Batched tree build.

    leaves: uint8 (..., n, leaf_bytes) → (root (..., 32), proofs
    (..., n, depth, 32), mask (n, depth) int8 — per leaf and level, whether
    the node had a sibling).  Levels run leaf → root; missing-sibling
    levels hold zeros in ``proofs``.
    """
    dev = leaves.device
    n = leaves.shape[-2]
    level = sha3_256(leaves)  # (..., n, 32)
    depth = 0
    w = n
    while w > 1:
        depth += 1
        w = (w + 1) // 2
    batch = leaves.shape[:-2]
    proof = torch.zeros((*batch, n, max(depth, 1), 32), dtype=torch.uint8,
                        device=dev)
    mask = torch.zeros((n, max(depth, 1)), dtype=torch.int8, device=dev)
    pos = np.arange(n)  # leaf → node position at this level (static)
    width = n
    d = 0
    while width > 1:
        sib = pos ^ 1
        has = sib < width
        take = torch.from_numpy(np.where(has, sib, pos)).to(dev)
        has_t = torch.from_numpy(has).to(dev)
        sib_digest = level.index_select(-2, take)
        proof[..., :, d, :] = torch.where(has_t[:, None], sib_digest, 0)
        mask[:, d] = has_t.to(torch.int8)
        level = _parents(level, width)
        pos = pos // 2
        width = (width + 1) // 2
        d += 1
    return level[..., 0, :], proof, mask


def merkle_root(leaves: torch.Tensor) -> torch.Tensor:
    """Root only: uint8 (..., n, leaf_bytes) → (..., 32)."""
    level = sha3_256(leaves)
    width = leaves.shape[-2]
    while width > 1:
        level = _parents(level, width)
        width = (width + 1) // 2
    return level[..., 0, :]


def merkle_verify(values, indices, roots, proofs, mask) -> torch.Tensor:
    """Batched proof verification.

    values: uint8 (..., leaf_bytes); indices: int (...,); roots (..., 32);
    proofs (..., depth, 32); mask (..., depth).  Returns bool (...,).
    """
    h = sha3_256(values)
    idx = indices
    for d in range(proofs.shape[-2]):
        sib = proofs[..., d, :]
        has = mask[..., d].bool()
        is_right = (idx % 2).bool()  # right child → sibling on the left
        cat_l = torch.cat([sib.expand_as(h), h], dim=-1)
        cat_r = torch.cat([h, sib.expand_as(h)], dim=-1)
        hashed = sha3_256(torch.where(is_right[..., None], cat_l, cat_r))
        h = torch.where(has[..., None], hashed, h)
        idx = idx // 2
    return (h == roots).all(dim=-1)
