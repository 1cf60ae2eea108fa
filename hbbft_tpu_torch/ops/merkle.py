"""Merkle trees over SHA3-256 digests: host trees and batched device trees.

Counterpart of ``hbbft_tpu/ops/merkle.py`` (reference:
``src/broadcast/merkle.rs``).  Tree shape: leaves are ``sha3_256(value)``;
at every level pairs hash to ``sha3_256(left || right)`` and an odd
trailing node is carried up unchanged.

- **Host** (object mode's ``Broadcast``): :class:`MerkleTree` and
  :class:`Proof` over ``bytes``, with hashlib per leaf and the native
  oracle's batch hasher for equal-length rows from ``_BATCH_MIN_BYTES``.
- **Device** (the batched RBC): :func:`merkle_build`, :func:`merkle_root`,
  :func:`merkle_verify` (the reference's ``merkle_*_jax``); every hash
  goes through :func:`hbbft_tpu_torch.ops.keccak.sha3_256` — one kernel
  launch per tree level on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.ops.keccak import sha3_256, sha3_256_host

Digest = bytes  # 32 bytes

# Below this many total bytes the per-call overhead of the native batch
# hasher beats its 4-way SIMD win; small trees stay on hashlib.
_BATCH_MIN_BYTES = 2048

_batch_fn = None
_batch_checked = False


def _sha3_batch():
    """Native equal-length batch hasher ((n, L) uint8 → (n, 32)), or None."""
    global _batch_fn, _batch_checked
    if not _batch_checked:
        _batch_checked = True
        try:
            from hbbft_tpu_torch.native.oracle import get_oracle

            _batch_fn = get_oracle().sha3_256_batch
        except Exception:
            _batch_fn = None
    return _batch_fn


def _hash_rows(arr: np.ndarray) -> List[Digest]:
    """Digest every row of a contiguous (n, L) uint8 array, batched."""
    batch = _sha3_batch()
    if batch is not None and arr.size >= _BATCH_MIN_BYTES:
        dig = batch(arr)
        return [dig[i].tobytes() for i in range(arr.shape[0])]
    return [sha3_256_host(arr[i].tobytes()) for i in range(arr.shape[0])]


def _leaf_digests(values: Sequence[bytes]) -> List[Digest]:
    """Leaf hashing: equal-length leaf sets go through the batch hasher
    (commitment cost scales with bytes, not leaves); ragged sets fall back
    to per-leaf hashlib."""
    n = len(values)
    if n >= 2:
        L = len(values[0])
        if L > 0 and n * L >= _BATCH_MIN_BYTES and all(
            len(v) == L for v in values
        ) and _sha3_batch() is not None:
            arr = np.empty((n, L), dtype=np.uint8)
            for i, v in enumerate(values):
                arr[i] = np.frombuffer(v, dtype=np.uint8)
            dig = _sha3_batch()(arr)
            return [dig[i].tobytes() for i in range(n)]
    return [sha3_256_host(v) for v in values]


@dataclass(frozen=True)
class Proof:
    """Inclusion proof for ``value`` at ``index`` under ``root_hash``.

    ``path`` lists (sibling_digest, sibling_on_left) from leaf level up;
    levels where the node had no sibling (odd carry) are skipped.
    Reference: ``src/broadcast/merkle.rs :: Proof``.
    """

    value: bytes
    index: int
    root_hash: Digest
    path: Tuple[Tuple[Digest, bool], ...]

    def __getstate__(self):
        # zero-copy proofs hold memoryview leaves, which neither pickle
        # nor deepcopy; snapshots materialize the slice here — the one
        # cold path where the copy is the point
        state = dict(self.__dict__)
        if isinstance(state["value"], memoryview):
            state["value"] = bytes(state["value"])
        return state

    def __setstate__(self, state) -> None:
        self.__dict__.update(state)  # bypasses the frozen __setattr__

    def validate(self, n_leaves: int) -> bool:
        """Check the proof against its own root (and index bounds).

        Reference: ``Proof::validate``.
        """
        if not 0 <= self.index < n_leaves:
            return False
        h = sha3_256_host(self.value)
        idx, width = self.index, n_leaves
        path = list(self.path)
        while width > 1:
            if (idx ^ 1) < width:  # this level has a sibling
                if not path:
                    return False
                sibling, sib_left = path.pop(0)
                if sib_left != (idx % 2 == 1):
                    return False
                h = (
                    sha3_256_host(sibling + h)
                    if sib_left
                    else sha3_256_host(h + sibling)
                )
            idx //= 2
            width = (width + 1) // 2
        return not path and h == self.root_hash


class MerkleTree:
    """Reference: ``src/broadcast/merkle.rs :: MerkleTree``."""

    def __init__(self, values: Sequence[bytes]):
        if not values:
            raise ValueError("MerkleTree needs at least one leaf")
        # bytes and memoryview leaves are stored as-is (memoryview slices of
        # one shared buffer make the proposer path zero-copy); anything else
        # is converted once, and the conversion count is exposed so the
        # hot-path test can assert the pipeline stays copy-free
        self.values: List[bytes] = []
        self.leaf_copies = 0
        for v in values:
            if not isinstance(v, (bytes, memoryview)):
                v = bytes(v)
                self.leaf_copies += 1
            self.values.append(v)
        self.levels: List[List[Digest]] = self._build_levels(
            _leaf_digests(self.values)
        )

    @staticmethod
    def _build_levels(level0: List[Digest]) -> List[List[Digest]]:
        levels = [level0]
        while len(levels[-1]) > 1:
            prev = levels[-1]
            pairs = len(prev) // 2
            if pairs * 64 >= _BATCH_MIN_BYTES and _sha3_batch() is not None:
                buf = np.frombuffer(
                    b"".join(prev[: 2 * pairs]), dtype=np.uint8
                ).reshape(pairs, 64)
                nxt = _hash_rows(buf)
            else:
                nxt = [
                    sha3_256_host(prev[i] + prev[i + 1])
                    for i in range(0, len(prev) - 1, 2)
                ]
            if len(prev) % 2 == 1:
                nxt.append(prev[-1])  # odd carry
            levels.append(nxt)
        return levels

    @classmethod
    def from_vec(cls, values: Sequence[bytes]) -> "MerkleTree":
        return cls(values)

    @classmethod
    def from_shards(
        cls, arr: np.ndarray, leaves: Sequence[bytes]
    ) -> "MerkleTree":
        """Build from a contiguous (n, B) uint8 shard array without copying.

        ``arr`` feeds the batch hasher directly; ``leaves`` supplies the
        per-shard buffers stored as proof values (typically memoryview
        slices of ONE bytes object over the same shard data) — the encode →
        commit path of :mod:`hbbft_tpu_torch.protocols.broadcast` touches
        each shard byte exactly once here.
        """
        n, B = arr.shape
        if n != len(leaves) or any(len(v) != B for v in leaves):
            raise ValueError("leaves must mirror the shard array")
        tree = cls.__new__(cls)
        tree.values = list(leaves)
        tree.leaf_copies = 0
        tree.levels = cls._build_levels(_hash_rows(arr))
        return tree

    def root_hash(self) -> Digest:
        return self.levels[-1][0]

    def proof(self, index: int) -> Optional[Proof]:
        if not 0 <= index < len(self.values):
            return None
        path = []
        idx = index
        for level in self.levels[:-1]:
            sib = idx ^ 1
            if sib < len(level):
                path.append((level[sib], sib < idx))
            idx //= 2
        return Proof(
            value=self.values[index],
            index=index,
            root_hash=self.root_hash(),
            path=tuple(path),
        )


# ---------------------------------------------------------------------------
# Device (batched) path
# ---------------------------------------------------------------------------



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
